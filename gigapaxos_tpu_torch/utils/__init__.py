from .config import Config
from .profiler import DelayProfiler

__all__ = ["Config", "DelayProfiler"]
