from .container import Container

__all__ = ["Container"]
