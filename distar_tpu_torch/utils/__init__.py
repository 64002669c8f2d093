from .config import Config, deep_merge_dicts

__all__ = ["Config", "deep_merge_dicts"]
