"""95th percentile of every iteration's time in the window, from CUDA
events on the stream at iteration boundaries, read after the window."""

import numpy as np


def read(run):
    return float(np.percentile(run.iteration_ms, 95))
