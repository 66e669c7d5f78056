from .container import Container, NotPortedError

__all__ = ["Container", "NotPortedError"]
