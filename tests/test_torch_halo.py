"""The port's halo exchange, sharded operator and sharded V-cycle against the
port's own single-device code, on the CPU.

Shards are `["cpu"] * n`: every line of the exchange runs, the copies are
device-local.  float64.  The sharded operator runs the unchanged
single-device functions on extended blocks, so its applies agree to 1e-12
(in fact bitwise here); the V-cycle and its setup agree to 1e-10 (sums in
shard order, the filter's conv on other shapes).
"""

import numpy as np
import pytest
import torch

import easysimp_tpu_torch as pt
from easysimp_tpu_torch.ops.multigrid import MultigridPreconditioner
from easysimp_tpu_torch.parallel.halo import HaloVoxelOperator, extend
from easysimp_tpu_torch.parallel.sharded_multigrid import ShardedMultigrid
from easysimp_tpu_torch.parallel.sharding import (
    GridLayout,
    ShardedField,
    make_mesh,
)

SPLITS = [(8, 1, 1), (4, 2, 1), (2, 2, 2)]


def _layout(shape, nels):
    n = int(np.prod(shape))
    return GridLayout(make_mesh(n, shape=shape, devices=["cpu"] * n), nels)


def _problem(nels, seed=0):
    """Cantilever operator, free mask, moduli of a mild design and a masked
    random node field, from `seed` with numpy."""
    grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(float(n) for n in nels))
    bc = pt.apply_fixed_boundary(
        grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    op = pt.VoxelOperator(grid, E0=1.0, Emin=1e-9, nu=0.3, p=3.0,
                          dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    mask = torch.tensor(pt.build_free_mask(grid, [bc]), dtype=torch.float64)
    scale = op.youngs_modulus(torch.tensor(rng.uniform(0.3, 1.0, nels)))
    u = torch.tensor(rng.standard_normal((*grid.nnodes_per_axis, 3))) * mask
    return op, mask, scale, u


def _gathered(f):
    return f.gather() if isinstance(f, ShardedField) else f


@pytest.mark.parametrize("shape", SPLITS + [(1, 4, 2)])
@pytest.mark.parametrize("kind", ["cell", "node"])
def test_layout_roundtrip(shape, kind):
    """split then gather is the identity; node blocks own their planes once
    (the last shard of an axis also owns the final plane)."""
    L = _layout(shape, (16, 8, 4))
    full = (16, 8, 4) if kind == "cell" else (17, 9, 5, 3)
    t = torch.arange(np.prod(full), dtype=torch.float64).reshape(full)
    f = L.split(t, kind)
    assert torch.equal(L.gather(f), t)
    assert sum(b.numel() for b in f.blocks) == t.numel()
    assert tuple(f.shape) == full


def test_pvdot_counts_each_node_once():
    op, mask, scale, u = _problem((16, 8, 4))
    L = _layout((2, 2, 2), (16, 8, 4))
    h = HaloVoxelOperator(op, L)
    uf = h.to_local_layout(u)
    ones = L.split(torch.ones_like(u), "node")
    assert float(h.pvdot(ones, ones)) == u.numel()
    assert abs(float(h.pvdot(uf, uf)) - float((u * u).sum())) <= \
        1e-12 * float((u * u).sum())
    assert torch.equal(h.from_local_layout(uf), u)


@pytest.mark.parametrize("shape", SPLITS)
def test_sharded_operator_matches_unsharded(shape):
    """The masked matvec (float64, 16x8x4) and the other operator methods
    on sharded fields against the single-device operator."""
    op, mask, scale, u = _problem((16, 8, 4))
    L = _layout(shape, (16, 8, 4))
    h = HaloVoxelOperator(op, L)
    U, S, M = L.split(u, "node"), L.split(scale, "cell"), L.split(mask, "node")
    pairs = [
        (h.apply(U, S, M), op.apply(u, scale, mask)),
        (h.apply_lame(U, S, 0.5 * S, M), op.apply_lame(u, scale, 0.5 * scale,
                                                       mask)),
        (h.diagonal(S, M), op.diagonal(scale, mask)),
        (h.row_abs_sums(S, M), op.row_abs_sums(scale, mask)),
        (h.element_energies_unit(U), op.element_energies_unit(u)),
        (h.element_energies_lame(U)[1], op.element_energies_lame(u)[1]),
        (h.body_force(S, [0.0, 0.0, -9.81], 2.0, 1.0),
         pt.loads.voxel_body_force(scale, [0.0, 0.0, -9.81], 2.0, 1.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(L.gather(got).numpy(), want.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_extend_reaches_past_the_neighbour():
    """A reach wider than a neighbour's block takes planes from the shards
    beyond it, corners included, and counts the copies."""
    L = _layout((8, 1, 1), (16, 8, 4))            # 2 cells per shard in x
    t = torch.arange(16 * 8 * 4, dtype=torch.float64).reshape(16, 8, 4)
    before = extend.copies
    blocks, starts = extend(L.split(t, "cell"), (3, 1, 0), (3, 1, 0))
    assert extend.copies > before
    for b, (sx, sy, sz) in zip(blocks, starts):
        assert torch.equal(b, t[sx:sx + b.shape[0], sy:sy + b.shape[1],
                                sz:sz + b.shape[2]])
    assert blocks[3].shape[0] == 2 + 6               # three each way


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 1, 1), (8, 1, 1)])
def test_sharded_vcycle_matches_unsharded(shape, monkeypatch):
    """Setup (power vectors), full and light, and M(r) on 16x8x8 with the
    coarsest level lowered so that a coarse level is distributed where the
    split allows (2 cells per shard and axis)."""
    monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", "100")
    op, mask, scale, r = _problem((16, 8, 8), seed=3)
    L = _layout(shape, (16, 8, 8))
    kw = dict(smooth_iters=(1, 2))
    mg = MultigridPreconditioner(op, **kw)
    smg = ShardedMultigrid(HaloVoxelOperator(op, L), **kw)
    assert smg.n_levels == mg.n_levels == 4
    assert smg.n_distributed == (1 if shape == (8, 1, 1) else 2)
    S, M, R = L.split(scale, "cell"), L.split(mask, "node"), L.split(r, "node")
    state, pv = mg.setup(scale, mask)
    sstate, spv = smg.setup(S, M)
    for a, b in zip(spv, pv):
        np.testing.assert_allclose(_gathered(a).numpy(), b.numpy(),
                                   rtol=1e-10, atol=1e-12)
    want = mg.make_M(state)(r)
    got = L.gather(smg.make_M(sstate)(R))
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    light, _ = mg.setup_light(scale, mask, pv, state)
    slight, _ = smg.setup_light(S, M, spv, sstate)
    want = mg.make_M(light)(r)
    got = L.gather(smg.make_M(slight)(R))
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_sharded_field_refuses_split_axis_ops():
    L = _layout((2, 2, 2), (4, 4, 4))
    f = L.split(torch.zeros(5, 5, 5, 3, dtype=torch.float64), "node")
    for bad in (lambda: f.reshape(-1), lambda: f[0], lambda: f.sum(dim=0),
                lambda: torch.nn.functional.pad(f, (1, 1)),
                # ops off the allow-list, even where per shard they would
                # keep the block's shape
                lambda: f.std(), lambda: torch.softmax(f, dim=0),
                lambda: torch.cumprod(f, dim=-1), lambda: torch.sort(f),
                lambda: torch.linalg.vector_norm(f),
                # an allowed op whose per-shard result loses the layout
                lambda: torch.stack([f, f], dim=-1)):
        with pytest.raises(TypeError):
            bad()
    assert float(torch.ones_like(f).sum()) == 5 * 5 * 5 * 3
    assert tuple(f.sum(dim=-1).shape) == (5, 5, 5)   # per shard, comp axis


def test_element_sharded_operator_and_filter():
    """The element-split operator, block Jacobi and filter against the
    single-device ones (float64, 1e-12)."""
    from easysimp_tpu_torch.ops.elements import element_stiffness_batch_np
    from easysimp_tpu_torch.parallel.element_step import (
        ElementShardedFilter,
        ElementShardedOperator,
    )
    from easysimp_tpu_torch.parallel.sharding import (
        ElementLayout,
        make_element_mesh,
    )

    mesh = pt.tet_mesh_from_grid(pt.generate_grid((4, 2, 2), (0, 0, 0),
                                                  (4.0, 2.0, 2.0)))
    ke, vols = element_stiffness_batch_np(
        mesh.node_coords[mesh.connectivity], E=1.0, nu=0.3)
    args = (ke, mesh.connectivity, mesh.n_nodes, 1.0, 1e-9, 0.3, 3.0)
    op = pt.UnstructuredOperator(*args, dtype=torch.float64, device="cpu")
    L = ElementLayout(make_element_mesh(mesh.n_cells, devices=["cpu"] * 8),
                      mesh.n_cells)
    sop = ElementShardedOperator(*args, layout=L, dtype=torch.float64)
    filt = pt.UnstructuredFilter(mesh.cell_centers, vols, 1.5,
                                 dtype=torch.float64, device="cpu")
    sfilt = ElementShardedFilter(filt, L)
    rng = np.random.default_rng(1)
    rho = torch.tensor(rng.uniform(0.1, 1.0, mesh.n_cells))
    s = torch.tensor(-rng.uniform(0.1, 1.0, mesh.n_cells))
    u = torch.tensor(rng.standard_normal(mesh.n_dofs))
    mask = torch.tensor((rng.uniform(size=mesh.n_dofs) > 0.1).astype(float))
    E, R, Sv = op.youngs_modulus(rho), L.split(rho), L.split(s)
    pairs = [
        (sop.apply(u, sop.youngs_modulus(R), mask), op.apply(u, E, mask)),
        (sop.block_diagonal_inverse(sop.youngs_modulus(R), mask),
         op.block_diagonal_inverse(E, mask)),
        (L.gather(sop.element_energies_unit(u)),
         op.element_energies_unit(u)),
        (L.gather(sfilt.density_filter(R)), filt.density_filter(rho)),
        (L.gather(sfilt.sensitivity_filter(R, Sv)),
         filt.sensitivity_filter(rho, s)),
        (L.gather(sfilt.chain_rule(Sv)), filt.chain_rule(s)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
