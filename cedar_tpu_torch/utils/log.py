"""Leveled, colored logging (reference: include/cedar/util/log.h:16-75).

Six channels — status, info, error, memory, debug, timer — gated by the
config's "log" array (default: status + error), with a push/pop header stack
so nested solvers (redistributed coarse solves, embedded plane solves) log
under a pushed prefix, matching the reference's `log::push_level`
(src/util/log.cc:66-79).
"""

from __future__ import annotations

import sys

_COLORS = {
    "status": "\033[32m",
    "info": "\033[37m",
    "error": "\033[31m",
    "memory": "\033[35m",
    "debug": "\033[36m",
    "timer": "\033[33m",
}
_RESET = "\033[0m"

_enabled = {"status", "error"}
_header_stack: list[str] = []
_use_color = sys.stdout.isatty()


def set_enabled(channels) -> None:
    global _enabled
    _enabled = set(channels)


def enabled(channel: str) -> bool:
    return channel in _enabled


def push_level(name: str, channels=None) -> None:
    _header_stack.append(name)
    if channels is not None:
        set_enabled(channels)


def pop_level() -> None:
    if _header_stack:
        _header_stack.pop()


def _emit(channel: str, msg: str) -> None:
    if channel not in _enabled:
        return
    prefix = "".join(f"({h}) " for h in _header_stack)
    if _use_color:
        line = f"{_COLORS[channel]}{prefix}{msg}{_RESET}"
    else:
        line = f"{prefix}{msg}"
    print(line, flush=True)


def status(msg: str) -> None:
    _emit("status", msg)


def info(msg: str) -> None:
    _emit("info", msg)


def error(msg: str) -> None:
    _emit("error", msg)


def memory(msg: str) -> None:
    _emit("memory", msg)


def debug(msg: str) -> None:
    _emit("debug", msg)


def timer(msg: str) -> None:
    _emit("timer", msg)
