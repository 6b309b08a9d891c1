"""Share of the traced episodes' wall time in which no operation ran on
the device: 100 (1 - busy / window), busy the union of the device
operations' intervals in the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / 1e6 / run.trace_window_s)
