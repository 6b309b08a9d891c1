"""Peak device memory allocated over the whole run, set-up included, in
GB (1e9 bytes): `torch.cuda.max_memory_allocated()`."""


def read(run):
    return run.memory_peak_bytes / 1e9
