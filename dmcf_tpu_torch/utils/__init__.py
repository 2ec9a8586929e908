from .config import Config, ConfigDict

__all__ = ["Config", "ConfigDict"]
