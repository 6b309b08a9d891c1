"""Seconds from the harness's first line to the window's start: imports,
the program's build (and on a first run its kernel build), the start state
and one warm-up episode."""


def read(run):
    return run.setup_s
