"""Leveled diagnostics (ref: src/dsv.h:292-324, src/dsv.c:19-39).

The reference gates DSV_ERROR/WARNING/INFO/DEBUG macros on a global level
set by the CLI's -l<n> flag; this mirrors that surface (plus a helper
for the instrumented-allocator-style report, which here reads PyTorch's
CUDA caching allocator instead of a malloc wrapper).
"""
import sys

LEVEL_ERROR = 0
LEVEL_WARNING = 1
LEVEL_INFO = 2
LEVEL_DEBUG = 3

_level = LEVEL_ERROR
_names = {0: "ERROR", 1: "WARNING", 2: "INFO", 3: "DEBUG"}


def set_level(level):
    global _level
    _level = int(level)


def get_level():
    return _level


def _emit(level, msg, *args):
    if level <= _level:
        if args:
            msg = msg % args
        print("[DSV %s] %s" % (_names[level], msg), file=sys.stderr)


def error(msg, *args):
    _emit(LEVEL_ERROR, msg, *args)


def warning(msg, *args):
    _emit(LEVEL_WARNING, msg, *args)


def info(msg, *args):
    _emit(LEVEL_INFO, msg, *args)


def debug(msg, *args):
    _emit(LEVEL_DEBUG, msg, *args)


def mem_report():
    """Device-buffer usage summary (the reference reports malloc peaks;
    dsv.c:41-88): (live allocations, their bytes) of the CUDA caching
    allocator, from torch.cuda.memory_stats(); (0, 0) when this process
    has not used a card."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0, 0
    st = torch.cuda.memory_stats()
    return (int(st.get("active.all.current", 0)),
            int(st.get("active_bytes.all.current", 0)))
