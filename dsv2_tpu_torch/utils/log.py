"""Leveled diagnostics (ref: src/dsv.h:292-324, src/dsv.c:19-39).

The reference gates DSV_ERROR/WARNING/INFO/DEBUG macros on a global level
set by the CLI's -l<n> flag; this mirrors that surface (the JAX
package's device-buffer report is left out: the port's CLI does not
print one).
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

