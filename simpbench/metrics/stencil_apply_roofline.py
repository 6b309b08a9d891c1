"""Share of its roofline that the hand `stencil_apply` kernel (the
multigrid's masked stencil apply) reaches in the traced episodes: the
least time of its launches, their bytes at the card's bandwidth, over the
launches' measured device time.  The trace names the kernel, replayed or
not, but not the level it ran on, so the bytes come from the program: its
`bytes.stencil_apply` counter (each tensor read once, the output written
once) over its `launch.stencil_apply.*` counters is the mean bytes of a
launch over the process, set-up included, and the trace's launches are
taken at that mean.  Every episode runs the same schedule, so the mean is
the traced episodes' own up to their CG counts; where set-up runs a
coarser grid first (`cantilever128-developed`'s 64^3 prelude) the mean is
lower and the share reads low.  Published peaks at 700 W: read it beside
the card's power limit.  None where the program keeps no such counter."""

from simpbench.roofline import HBM_BYTES_PER_S


def read(run):
    if run.trace is None:
        return None
    try:
        from easysimp_tpu_torch.tracing import counters
    except ImportError:
        return None
    c = counters()
    launches = sum(n for k, n in c.items()
                   if k.startswith("launch.stencil_apply."))
    nbytes = c.get("bytes.stencil_apply", 0)
    spent = [op.dur for op in run.trace.ops if "stencil_apply" in op.name]
    if not launches or not nbytes or not spent or not sum(spent):
        return None
    bound = len(spent) * nbytes / launches / HBM_BYTES_PER_S
    return 100.0 * bound / (sum(spent) / 1e6)
