"""ANSI-styled terminal printing.

Port of easysimp_tpu/utils/terminal.py; API parity with EasySIMP.jl's
terminal styling (src/Utils/TerminalStyle.jl:2-59): `[INFO]`, `[ERROR]`,
`[WARNING]`, `[SUCCESS]`, `[DATA]` prefixes in color.  Honors NO_COLOR and
non-tty stdout.
"""

from __future__ import annotations

import os
import sys

__all__ = [
    "print_info",
    "print_error",
    "print_warning",
    "print_success",
    "print_data",
    "set_quiet",
]

_RESET = "\033[0m"
_COLORS = {
    "INFO": "\033[36m",      # cyan
    "ERROR": "\033[31m",     # red
    "WARNING": "\033[33m",   # yellow
    "SUCCESS": "\033[32m",   # green
    "DATA": "\033[35m",      # magenta
}

_QUIET = False


def set_quiet(quiet: bool = True) -> None:
    """Silence all styled prints (useful in benchmarks where stdout is JSON)."""
    global _QUIET
    _QUIET = bool(quiet)


def _use_color(file) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(file, "isatty") and file.isatty()


def _emit(tag: str, msg: str, file=None) -> None:
    if _QUIET:
        return
    file = file if file is not None else sys.stdout
    if _use_color(file):
        print(f"{_COLORS[tag]}[{tag}]{_RESET} {msg}", file=file)
    else:
        print(f"[{tag}] {msg}", file=file)


def print_info(msg: str) -> None:
    _emit("INFO", str(msg))


def print_error(msg: str) -> None:
    _emit("ERROR", str(msg), file=sys.stderr)


def print_warning(msg: str) -> None:
    _emit("WARNING", str(msg))


def print_success(msg: str) -> None:
    _emit("SUCCESS", str(msg))


def print_data(msg: str) -> None:
    _emit("DATA", str(msg))
