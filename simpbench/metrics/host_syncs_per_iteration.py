"""Host syncs per SIMP iteration: the program's `sync.*` counters (each
read of a device value on the host, `easysimp_tpu_torch.tracing`) over its
`steps` counter (SIMP iterations), both as the process ends the window.
They count every iteration the process ran: the warm-up episode and every
episode of the window, traced or not.  So the reading is an episode's count
per iteration only in a cell whose set-up runs no iteration and waits for
no device value outside an episode, as in the cells listed for it; where
set-up runs the trajectory (`cantilever128-developed`) it would depend on
the number of window episodes.  None where the program keeps no such
counters."""


def read(run):
    try:
        from easysimp_tpu_torch.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("steps"):
        return None
    return sum(n for k, n in c.items() if k.startswith("sync.")) / c["steps"]
