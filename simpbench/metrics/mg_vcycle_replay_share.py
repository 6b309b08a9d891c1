"""Share of the multigrid preconditioner's M(r) calls that replayed the
hierarchy's V-cycle CUDA graph: 100 replay / (replay + eager), the
program's `mg.graph.replay` and `mg.graph.eager` counters
(`easysimp_tpu_torch.tracing`; the call that captures a hierarchy's graph
is neither) as the process ends the window.  Like
`host_syncs_per_iteration` it counts every call the process made, set-up
included.  None where the program keeps no such counters."""


def read(run):
    try:
        from easysimp_tpu_torch.tracing import counters
    except ImportError:
        return None
    c = counters()
    replay, eager = c.get("mg.graph.replay", 0), c.get("mg.graph.eager", 0)
    if not replay + eager:
        return None
    return 100.0 * replay / (replay + eager)
