from .registry import ARCHS, all_configs, get_config

__all__ = ["ARCHS", "all_configs", "get_config"]
