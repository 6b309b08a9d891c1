"""CPU tests of the `mbb256` configuration (the 2x1x1 MBB beam at
256x128x128): its data against the port's own model, its hierarchy and its
matvec bound, all computed from shapes or at its tiny size:

    python -m pytest simpbench/tests -q -p no:cacheprovider --noconftest
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from simpbench import cells, reference, roofline, systems

NELS = (256, 128, 128)


def config():
    return cells.load_cell("mbb256-cold").config


def port_mask_and_load(cfg, nels):
    """The port's free mask and load field of the configuration, built by
    the harness's system from the data."""
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.bcs import build_free_mask
    from easysimp_tpu_torch.loads import build_load_field
    from simpbench.systems.voxel import port_grid

    grid = port_grid(pt, nels)
    bcs, loads = systems.boundary(pt, grid, cfg, nels)
    return build_free_mask(grid, bcs), build_load_field(grid, loads)


@pytest.mark.parametrize("level", [0, 1])
def test_data_gives_build_mbb(level):
    """At the tiny size and its first coarser level, the committed
    configuration gives `build_mbb`'s free mask and load field bit for
    bit, in the reference (float64 and the control's float32) and in the
    port; its material is `build_mbb`'s."""
    from easysimp_tpu_torch.bcs import build_free_mask
    from easysimp_tpu_torch.loads import build_load_field
    from easysimp_tpu_torch.models.beam_2x1x1 import build_mbb

    cfg = config()
    nels = tuple(n >> level for n in cfg["tiny_nels"])
    grid, loads, bcs, params, _ = build_mbb(nels=nels)
    want_mask = build_free_mask(grid, bcs)
    want_f = build_load_field(grid, loads)
    for precision in ("float64", "tf32"):
        P = reference.problem(cfg, nels, "cpu", precision)
        assert np.array_equal(P.mask.double().numpy(), want_mask)
        assert np.array_equal(P.f.double().numpy(),
                              want_f.astype(P.f.numpy().dtype))
    mask, f = port_mask_and_load(cfg, nels)
    assert np.array_equal(mask, want_mask) and np.array_equal(f, want_f)
    fixed = (want_mask == 0).sum(-1)
    assert ((fixed > 0) & (fixed < 3)).any()          # sliding supports
    m = cfg["params"]
    assert (m["E0"], m["Emin"], m["nu"], m["p"], m["volume_fraction"],
            m["filter_radius"]) == (params.E0, params.Emin, params.nu,
                                    params.p, params.volume_fraction,
                                    params.filter_radius)


def test_six_levels_down_to_8x4x4(monkeypatch):
    """Under the default EASYSIMP_MAX_COARSE_DOFS the grid coarsens five
    times: 16x8x8 has 4,131 dofs, over the limit, so 8x4x4 (675 dofs) is
    the coarsest.  Injection keeps every support on the coarsest lattice
    (every 32nd node): the z pin at (0, 128, 64) and the roller's end
    x = 256."""
    from easysimp_tpu_torch.ops.multigrid import (_can_coarsen,
                                                  _coarsen_counts,
                                                  _max_coarse_dofs)

    monkeypatch.delenv("EASYSIMP_MAX_COARSE_DOFS", raising=False)
    cfg = config()
    assert tuple(cfg["nels"]) == NELS
    levels = [NELS]
    while _can_coarsen(levels[-1]):
        levels.append(_coarsen_counts(levels[-1]))
        if 3 * math.prod(n + 1 for n in levels[-1]) <= _max_coarse_dofs():
            break
    assert levels == [(256 >> k, 128 >> k, 128 >> k) for k in range(6)]
    assert 3 * math.prod(n + 1 for n in levels[-2]) == 4131
    assert 3 * math.prod(n + 1 for n in levels[-1]) == 675
    stride = 2 ** (len(levels) - 1)
    pin = cells.in_grid(cfg["supports"][2]["nodes"], cfg, NELS)["point"]
    roller = cells.in_grid(cfg["supports"][1]["nodes"], cfg, NELS)["max"]
    assert all(v % stride == 0 for v in pin)
    assert roller[0] % stride == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matvec_bound_twice_the_cube(dtype):
    """The voxel_matvec bound at 256x128x128 is twice the 128^3 one within
    1% (nodes (257 x 129 x 129) against 2 x 129^3)."""
    big, term = roofline.voxel_matvec_seconds(NELS, dtype)
    cube, _ = roofline.voxel_matvec_seconds((128, 128, 128), dtype)
    assert term == "bytes"
    assert abs(big / cube - 2.0) < 0.02
