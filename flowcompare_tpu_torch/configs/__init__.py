from .presets import PRESETS, derive, get_config

__all__ = ["PRESETS", "derive", "get_config"]
