"""The card's published peaks and the least time a kernel's work needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).  A
kernel's bound is the larger of its bytes (each input read once, the output
written once) over the memory bandwidth and its operations over the peak
rates.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12      # CUDA cores, outside the tensor cores

ITEMSIZE = {"float32": 4, "bfloat16": 2}


def voxel_matvec_bytes(nels, dtype):
    """Bytes of one `voxel_matvec` on an `nels` grid: the node field read
    and written, the cell scale read, the float32 24x24 ke read."""
    s = ITEMSIZE[dtype]
    nodes = math.prod(n + 1 for n in nels)
    return 2 * 3 * nodes * s + math.prod(nels) * s + 24 * 24 * 4


def voxel_matvec_seconds(nels, dtype):
    """(bound in seconds, "bytes" or "operations") of one `voxel_matvec`.
    Operations: three tensor-core products of 2 x 576 flops per cell (the
    3xTF32 split for float32 storage; ke in three bfloat16 pieces for
    bfloat16 storage), plus the scale, the sums and the dot on the CUDA
    cores (24 per cell, 21 per node)."""
    cells, nodes = math.prod(nels), math.prod(n + 1 for n in nels)
    rate = TF32_FLOPS if dtype == "float32" else BF16_FLOPS
    t_ops = 3 * 2 * 576 * cells / rate + (24 * cells + 21 * nodes) / FP32_FLOPS
    t_bytes = voxel_matvec_bytes(nels, dtype) / HBM_BYTES_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
