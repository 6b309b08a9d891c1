"""Sensitivity and density filters on voxel grids.

Port of `VoxelFilter` (easysimp_tpu/ops/filters.py:73-165).  On a uniform
voxel grid the reference's KD-tree cone filter H_ij = max(0, R - ||x_i-x_j||)
is a fixed 3-D stencil: one zero-padded `conv3d` with the cone kernel, plus a
normalization field W = conv(ones) that reproduces the boundary handling
(out-of-domain neighbours do not contribute).  Element volumes are uniform,
so they cancel where the reference formulas divide by them.

  sensitivity:  filt_i = conv(rho*s)_i / (max(1e-3, rho_i) * W_i)
  density:      rho~_e = conv(rho)_e / W_e
  chain rule:   out_e  = conv(s / W)_e

A float32 conv3d on CUDA runs in full float32 (TF32 is pinned off in
`config.py`).  The unstructured filter is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.terminal import print_data

__all__ = ["VoxelFilter", "create_filter_cache"]


def _cone_kernel(spacing, radius):
    """Cone kernel max(0, R - d) over integer cell-center offsets, float64."""
    hx, hy, hz = (float(s) for s in spacing)
    rx = max(0, int(np.floor(radius / hx + 1e-9)))
    ry = max(0, int(np.floor(radius / hy + 1e-9)))
    rz = max(0, int(np.floor(radius / hz + 1e-9)))
    ox = np.arange(-rx, rx + 1) * hx
    oy = np.arange(-ry, ry + 1) * hy
    oz = np.arange(-rz, rz + 1) * hz
    X, Y, Z = np.meshgrid(ox, oy, oz, indexing="ij")
    d = np.sqrt(X**2 + Y**2 + Z**2)
    return np.maximum(0.0, radius - d)


class VoxelFilter:
    """Convolution filter cache for structured voxel grids: the cone kernel
    and the boundary-normalization field, built once on `device`."""

    def __init__(self, grid, filter_radius_ratio, dtype=torch.float32,
                 device="cpu"):
        self.grid = grid
        self.dtype = dtype
        self.device = torch.device(device)
        self.filter_radius = float(filter_radius_ratio) \
            * grid.characteristic_element_size
        kern = _cone_kernel(grid.spacing, self.filter_radius)
        self._kernel = torch.as_tensor(kern, dtype=dtype,
                                       device=self.device)[None, None]
        self._padding = tuple(k // 2 for k in kern.shape)
        ones = torch.ones(grid.nels, dtype=dtype, device=self.device)
        self.weight_sum = self._conv(ones)  # W_i = sum_j H_ij (in-domain)
        print_data(
            f"FilterCache created: {grid.n_cells} cells, "
            f"r={self.filter_radius:.4f}, kernel={kern.shape}, "
            f"interior_neighbors={np.count_nonzero(kern)}"
        )

    def _conv(self, x):
        """Zero-padded ('same') 3-D cone convolution; the kernel is
        symmetric, so conv3d's cross-correlation is the convolution."""
        return F.conv3d(x[None, None], self._kernel,
                        padding=self._padding)[0, 0]

    def sensitivity_filter(self, design_rho, sens):
        """Sigmund sensitivity filter (SensitivityFilter.jl:33-67), called
        with DESIGN densities as the reference does."""
        num = self._conv(design_rho * sens)
        rho_safe = torch.clamp(design_rho, min=1e-3)
        return num / (rho_safe * self.weight_sum)

    def density_filter(self, design_rho):
        """rho~ = conv(rho) / W (DensityFilter.jl:30-60)."""
        return self._conv(design_rho) / self.weight_sum

    def chain_rule(self, sens_physical):
        """Transpose of the density filter (DensityFilter.jl:77-117)."""
        return self._conv(sens_physical / self.weight_sum)


def create_filter_cache(grid, filter_radius_ratio, dtype=torch.float32,
                        device="cpu"):
    """Filter cache with radius = ratio x characteristic element size
    (FilterCommon.jl:61-98).  Voxel grids only in this port."""
    from ..grids import VoxelGrid

    if not isinstance(grid, VoxelGrid):
        raise NotImplementedError("the unstructured filter is not ported yet")
    return VoxelFilter(grid, filter_radius_ratio, dtype=dtype, device=device)
