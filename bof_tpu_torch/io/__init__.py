from .store import BaseStore, MemStore, Ticket
from .stride import StrideInfo, buf_size
from .pystore import PyFileStore, PyIoPool

__all__ = ["BaseStore", "MemStore", "Ticket", "StrideInfo", "buf_size",
           "PyFileStore", "PyIoPool"]
