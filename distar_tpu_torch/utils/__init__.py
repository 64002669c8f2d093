from .config import Config, deep_merge_dicts, read_config

__all__ = ["Config", "deep_merge_dicts", "read_config"]
