"""Sensitivity and density filters.

Port of easysimp_tpu/ops/filters.py: `VoxelFilter` (:73-165) and
`UnstructuredFilter` (:168-224).  On a uniform
voxel grid the reference's KD-tree cone filter H_ij = max(0, R - ||x_i-x_j||)
is a fixed 3-D stencil: one zero-padded `conv3d` with the cone kernel, plus a
normalization field W = conv(ones) that reproduces the boundary handling
(out-of-domain neighbours do not contribute).  Element volumes are uniform,
so they cancel where the reference formulas divide by them.

  sensitivity:  filt_i = conv(rho*s)_i / (max(1e-3, rho_i) * W_i)
  density:      rho~_e = conv(rho)_e / W_e
  chain rule:   out_e  = conv(s / W)_e

A float32 conv3d on CUDA runs in full float32 (TF32 is pinned off in
`config.py`).

For unstructured meshes the neighbour lists are built on the host (the
port's native C++ grid-hash search, or scipy's cKDTree when g++ is missing)
and padded to a rectangular (n_cells, max_neighbors) gather table, so the
device-side filter is a gather and a weighted row reduction:

  sensitivity:  filt_i = sum_j H_ij rho_j s_j / V_j
                         / (max(1e-3, rho_i) / V_i * sum_j H_ij)
  density:      rho~_e = sum_j H_ej V_j rho_j / sum_j H_ej V_j
  chain rule:   out_e  = sum_i H_ie V_e / (sum_j H_ij V_j) * s_i
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.terminal import print_data

__all__ = ["VoxelFilter", "UnstructuredFilter", "FilterCacheTypes",
           "create_filter_cache"]


def _fixed_radius_csr(centers, radius):
    """All-pairs fixed-radius neighbors as CSR, and the route taken:
    (offsets, idx, cone weights, "native" or "scipy").

    Prefers the native C++ grid-hash search (easysimp_tpu_torch/native) and
    falls back to scipy.cKDTree when its build is unavailable; the route
    taken is printed."""
    try:
        from .. import native

        if native.is_available():
            out = native.neighbor_search(centers, radius)
            print_data("Neighbour search: native C++ grid hash")
            return (*out, "native")
    except Exception:
        pass  # fall through to scipy

    from scipy.spatial import cKDTree

    print_data("Neighbour search: scipy cKDTree (native build unavailable)")
    n = centers.shape[0]
    tree = cKDTree(centers)
    lists = tree.query_ball_point(centers, r=radius)
    counts = np.array([len(l) for l in lists], dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    idx = np.empty(offsets[-1], dtype=np.int32)
    weights = np.empty(offsets[-1], dtype=np.float64)
    for i, l in enumerate(lists):
        a = np.asarray(l, dtype=np.int32)
        d = np.linalg.norm(centers[a] - centers[i], axis=1)
        idx[offsets[i] : offsets[i + 1]] = a
        weights[offsets[i] : offsets[i + 1]] = np.maximum(0.0, radius - d)
    return offsets, idx, weights, "scipy"


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
                 device="cuda"):
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


class UnstructuredFilter:
    """Padded-neighbor-list filters for imported meshes.

    A host-side fixed-radius query (the reference's
    NearestNeighbors.inrange, FilterCommon.jl:82-90) produces a rectangular
    (n_cells, max_nb) index table + cone weights on `device`; the applies
    are gathers and row reductions (no scatter, so the sums have a fixed
    order).
    """

    def __init__(self, cell_centers, element_volumes, filter_radius,
                 dtype=torch.float32, device="cuda"):
        centers = np.asarray(cell_centers, dtype=np.float64)
        vols = np.asarray(element_volumes, dtype=np.float64)
        n = centers.shape[0]
        self.filter_radius = float(filter_radius)
        self.dtype = dtype
        self.device = torch.device(device)
        offsets, idx, w_csr, self.neighbor_route = _fixed_radius_csr(
            centers, self.filter_radius)
        counts = np.diff(offsets)
        max_nb = int(counts.max())
        nb = np.zeros((n, max_nb), dtype=np.int64)
        w = np.zeros((n, max_nb), dtype=np.float64)
        # CSR -> padded rows (padded entries keep weight 0)
        cols = (np.arange(len(idx)) - np.repeat(offsets[:-1], counts))
        rows = np.repeat(np.arange(n), counts)
        nb[rows, cols] = idx
        w[rows, cols] = w_csr
        self.neighbors = torch.as_tensor(nb, device=self.device)
        self.weights = torch.as_tensor(w, dtype=dtype, device=self.device)
        self.volumes = torch.as_tensor(vols, dtype=dtype, device=self.device)
        # sum_j H_ij and sum_j H_ij V_j, both including only real neighbors
        self.weight_sum = self.weights.sum(dim=1)
        self.wv_sum = (self.weights * self.volumes[self.neighbors]).sum(dim=1)
        # the rows this filter computes (all of them; see `row_block`) and
        # the whole-design fields its neighbour indices read
        self.rows = slice(None)
        self.all_volumes, self.all_wv_sum = self.volumes, self.wv_sum
        print_data(
            f"FilterCache created: {n} cells, r={self.filter_radius:.4f}, "
            f"avg_neighbors={counts.mean():.1f}"
        )

    def row_block(self, lo, hi, device):
        """The filter of rows lo:hi on `device`: its applies read the whole
        design and return those rows (one shard of an element split)."""
        blk = copy.copy(self)
        blk.device = torch.device(device)
        blk.rows = slice(lo, hi)
        for name in ("neighbors", "weights", "volumes", "weight_sum",
                     "wv_sum"):
            setattr(blk, name, getattr(self, name)[lo:hi].to(device))
        blk.all_volumes = self.all_volumes.to(device)
        blk.all_wv_sum = self.all_wv_sum.to(device)
        return blk

    def sensitivity_filter(self, design_rho, sens):
        rho_j = design_rho[self.neighbors]
        s_j = sens[self.neighbors]
        v_j = self.all_volumes[self.neighbors]
        num = (self.weights * rho_j * s_j / v_j).sum(dim=1)
        rho_safe = torch.clamp(design_rho[self.rows], min=1e-3)
        den = rho_safe / self.volumes * self.weight_sum
        return torch.where(self.weight_sum > 1e-12, num / den,
                           sens[self.rows])

    def density_filter(self, design_rho):
        rho_j = design_rho[self.neighbors]
        v_j = self.all_volumes[self.neighbors]
        num = (self.weights * v_j * rho_j).sum(dim=1)
        return torch.where(self.wv_sum > 1e-12, num / self.wv_sum,
                           design_rho[self.rows])

    def chain_rule(self, sens_physical):
        # out_e = V_e * sum_{i in nb(e)} H_ei * s_i / (sum_j H_ij V_j)
        # (H symmetric; neighbor relation symmetric).
        ratio = torch.where(self.all_wv_sum > 1e-12,
                            sens_physical / self.all_wv_sum,
                            torch.zeros_like(sens_physical))
        return self.volumes * (self.weights
                               * ratio[self.neighbors]).sum(dim=1)


#: Types a filter cache may be (for isinstance checks in user code).
FilterCacheTypes = (VoxelFilter, UnstructuredFilter)


def create_filter_cache(grid, filter_radius_ratio, element_volumes=None,
                        dtype=torch.float32, device="cuda"):
    """Filter cache with radius = ratio x characteristic element size
    (FilterCommon.jl:61-98).  Dispatches on the grid type: VoxelGrid ->
    convolution filter, unstructured mesh -> padded neighbor lists."""
    from ..grids import VoxelGrid

    if isinstance(grid, VoxelGrid):
        return VoxelFilter(grid, filter_radius_ratio, dtype=dtype,
                           device=device)
    radius = float(filter_radius_ratio) * grid.characteristic_element_size
    vols = element_volumes if element_volumes is not None \
        else grid.element_volumes
    return UnstructuredFilter(grid.cell_centers, vols, radius, dtype=dtype,
                              device=device)
