from .cache import Cache, get_hash
from .config import Config, ConfigDict
from .log import LogRecord, get_runid, make_dir, setup_logging

__all__ = [
    "Config",
    "ConfigDict",
    "LogRecord",
    "get_runid",
    "make_dir",
    "setup_logging",
    "Cache",
    "get_hash",
]
