from .env import Config, DictConfig, EnvConfig, load_env_file

__all__ = ["Config", "DictConfig", "EnvConfig", "load_env_file"]
