"""SIMP iterations completed in the window over the window's seconds
(whole episodes only; host clock, synchronised at both ends)."""


def read(run):
    return run.iterations / run.window_s
