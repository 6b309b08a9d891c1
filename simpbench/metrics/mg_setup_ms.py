"""Device milliseconds per SIMP iteration of the operations launched inside
the harness's span around `VoxelStep.setup` (the multigrid setup, full or
light), tied to the span by correlation id."""


def read(run):
    if run.trace is None or not run.traced_iterations:
        return None
    us = sum(op.dur for op in run.trace.ops if op.span == "setup")
    return us / 1e3 / run.traced_iterations if us else None
