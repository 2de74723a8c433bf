from .tiled_array import (TiledFlashArray, map_tiled_array, repack,
                          unpack)
from .flash_array import (FlashArray, flash_empty, flash_free, map_array,
                          mem_array)
from .task import FnTask, Task, TaskStatus, access_key
from .cache import TileCache
from .prioritizer import Prioritizer
from .scheduler import CompletionRecord, Scheduler, SchedulerOptions

__all__ = ["FlashArray", "flash_empty", "flash_free", "map_array",
           "mem_array", "FnTask", "Task", "TaskStatus", "access_key",
           "TileCache", "Prioritizer", "CompletionRecord", "Scheduler",
           "SchedulerOptions"]
