"""Thread-safe leveled logger (reference: include/bof_logger.h).

The reference has a mutex-guarded, ANSI-colored logger with levels
info/debug/error/warn/pass/fail/fatal and GLOG_* macros against a global
instance (bof_logger.h:61-189).  We wrap Python logging with the same level
vocabulary; fatal raises instead of exit(-1) so library users can recover.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time

_COLORS = {
    "DEBUG": "\033[36m", "INFO": "\033[0m", "WARNING": "\033[33m",
    "ERROR": "\033[31m", "CRITICAL": "\033[41m", "PASS": "\033[32m",
}
_RESET = "\033[0m"


class _Formatter(logging.Formatter):
    def format(self, record):
        t = time.strftime("%H:%M:%S", time.localtime(record.created))
        ms = int((record.created % 1) * 1000)
        color = _COLORS.get(record.levelname, "") if sys.stderr.isatty() else ""
        reset = _RESET if color else ""
        tid = threading.get_ident() % 100000
        return (f"{color}[{record.levelname[0]}{t}.{ms:03d} t{tid} "
                f"{record.name}:{record.funcName}] {record.getMessage()}{reset}")


class FlashFatal(RuntimeError):
    """Raised on unrecoverable errors (reference exits via GLOG_FATAL)."""


def get_logger(name: str = "bof") -> logging.Logger:
    log = logging.getLogger(name)
    if not getattr(log, "_bof_init", False):
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_Formatter())
        log.addHandler(h)
        log.propagate = False
        lvl = os.environ.get("BOF_LOG", "info").upper()
        log.setLevel(getattr(logging, lvl, logging.INFO))
        log._bof_init = True  # type: ignore[attr-defined]
    return log


LOG = get_logger()


def fatal(msg: str, *args):
    LOG.critical(msg % args if args else msg)
    raise FlashFatal(msg % args if args else msg)
