from .alignment import cdiv, fnv64a, is_sector_aligned, round_down, round_up
from .lexkey import lex_composite
from .logger import LOG, FlashFatal, fatal, get_logger
from .metrics import METRICS, Metrics
from .timer import Timer

__all__ = [
    "cdiv", "fnv64a", "is_sector_aligned", "round_down", "round_up",
    "LOG", "FlashFatal", "fatal", "get_logger", "METRICS", "Metrics", "Timer",
]
