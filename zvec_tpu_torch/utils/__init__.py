from .config import GlobalConfig
from .profiler import Profiler

__all__ = ["GlobalConfig", "Profiler"]
