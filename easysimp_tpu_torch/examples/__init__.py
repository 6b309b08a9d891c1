"""The port's example scripts, one per script of `examples/` with the same
file name and positional arguments, plus `--device` (default: cuda).

    python -m easysimp_tpu_torch.examples.01_basic_cantilever [results_dir] \
        [--device cpu]
"""
