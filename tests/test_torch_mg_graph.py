"""The multigrid's own state and the dispatch of its V-cycle graph
(ops/multigrid.py), on the CPU.

On one CUDA device a hierarchy keeps one state, pinned to its first free
mask, that every setup refreshes in place, and M(r) on it replays the
cycle's CUDA graph through a buffer that `cg_solve` computes its first
residual into.  Here: the refresh keeps every tensor's storage and gives
bitwise a fresh setup's values (the hierarchy told that its moduli are on
its card); a setup on another free mask leaves the own state alone; CPU
tensors and sharded fields take the eager cycle, counted, bitwise
`_vcycle`; with a stand-in capture, replays give the eager cycle's values
and counts and M returns tensors of its own; CG with an M that overwrites
one buffer iterates bitwise as with one that returns fresh tensors; the
`mg_vcycle_replay_share` and `stencil_apply_roofline` readers."""

import collections
import types

import numpy as np
import pytest
import torch

import easysimp_tpu_torch as pt
from easysimp_tpu_torch import tracing
from easysimp_tpu_torch.ops.cg import cg_solve, recycle_deflate
from easysimp_tpu_torch.ops.multigrid import MultigridPreconditioner
from easysimp_tpu_torch.parallel.halo import HaloVoxelOperator
from easysimp_tpu_torch.parallel.sharded_multigrid import ShardedMultigrid
from easysimp_tpu_torch.parallel.sharding import GridLayout, make_mesh
from easysimp_tpu_torch.ops import multigrid
from simpbench.metrics import mg_vcycle_replay_share, stencil_apply_roofline
from simpbench.roofline import HBM_BYTES_PER_S
from simpbench.trace import DeviceOp, Trace


def _problem(nels, dtype, seed=0):
    """Cantilever operator, free mask, three moduli fields of nearby
    designs and a masked random node field, from `seed`."""
    grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(float(n) for n in nels))
    bc = pt.apply_fixed_boundary(
        grid, pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6))
    op = pt.VoxelOperator(grid, E0=1.0, Emin=1e-9, nu=0.3, p=3.0,
                          dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed)
    mask = torch.tensor(pt.build_free_mask(grid, [bc]), dtype=dtype)
    d = rng.uniform(0.2, 1.0, nels)
    scales = [op.youngs_modulus(torch.tensor(
        np.clip(d + rng.uniform(-0.2, 0.2, nels) * k, 0.05, 1.0),
        dtype=dtype)) for k in range(3)]
    r = torch.tensor(rng.standard_normal((*grid.nnodes_per_axis, 3)),
                     dtype=dtype) * mask
    return op, mask, scales, r


def _leaves(x):
    """The tensors of a state (dicts in key order, lists, tuples)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


CASES = {"float64": (torch.float64, None),
         "float32-bf16-cycle": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("case", CASES)
def test_refresh_in_place_keeps_storage_and_is_a_fresh_setup(case,
                                                            monkeypatch):
    monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", "100")   # four levels
    dtype, lp = CASES[case]
    op, mask, (sA, sB, sC), _ = _problem((16, 8, 8), dtype)
    kw = dict(smooth_iters=(1, 2), cycle_dtype=lp)
    own = MultigridPreconditioner(op, **kw)
    own._on_card = lambda t: True          # moduli on the hierarchy's card
    fresh = MultigridPreconditioner(op, **kw)
    assert own.n_levels >= 3 and own.supports_light_setup
    sA_kept = sA.clone()
    pv = own.power_init(sA, mask)

    st, pv_o = own.setup(sA, mask, pv)
    want, pv_f = fresh.setup(sA, mask, pv)
    assert st is own._state and want is not fresh._state
    _bitwise(st, want)
    _bitwise(pv_o, pv_f)
    ptrs = [t.data_ptr() for t in _leaves(st)]

    # a light setup, then a full one, on the same hierarchy
    light, pv_o = own.setup_light(sB, mask, pv_o, st)
    want, pv_f = fresh.setup_light(sB, mask, pv_f, want)
    assert light is st
    assert [t.data_ptr() for t in _leaves(st)] == ptrs
    _bitwise(st, want)
    _bitwise(pv_o, pv_f)
    full, pv_o = own.setup(sC, mask, pv_o)
    want, pv_f = fresh.setup(sC, mask, pv_f)
    assert full is st
    assert [t.data_ptr() for t in _leaves(st)] == ptrs
    _bitwise(st, want)
    _bitwise(pv_o, pv_f)
    # the caller's moduli are not the state's storage
    assert torch.equal(sA, sA_kept)
    # level 0's mask is the free mask itself where the cycle keeps its dtype
    assert (st["masks"][0] is mask) == (lp is None)


def test_cpu_tensors_run_the_eager_cycle(monkeypatch):
    monkeypatch.setattr(tracing, "_counts", collections.Counter())
    op, mask, (s, *_), r = _problem((16, 8, 8), torch.float32)
    mg = MultigridPreconditioner(op, smooth_iters=(1, 2),
                                 cycle_dtype=torch.bfloat16)
    state, _ = mg.setup(s, mask)
    assert mg._state is None              # a CPU setup keeps no state
    M = mg.make_M(state)
    assert not hasattr(M, "buffer")
    got = M(r)
    want = mg._vcycle(0, state, r.to(torch.bfloat16)).to(r.dtype)
    assert torch.equal(got, want)
    # the hierarchy's own state, given a CPU residual: eager, and its M
    # offers the buffer; another state offers none
    mg._on_card = lambda t: t is s
    state, _ = mg.setup(s, mask)
    M = mg.make_M(state)
    assert state is mg._state and M.buffer.shape == r.shape
    assert torch.equal(M(r), want)
    assert torch.equal(M.into_buffer(r), want)
    assert not hasattr(mg.make_M(dict(state)), "buffer")
    assert tracing.counters() == {"mg.graph.eager": 3}


def test_a_sharded_field_runs_the_eager_cycle(monkeypatch):
    monkeypatch.setattr(tracing, "_counts", collections.Counter())
    op, mask, (s, *_), r = _problem((8, 4, 4), torch.float64)
    L = GridLayout(make_mesh(2, shape=(2, 1, 1), devices=["cpu"] * 2),
                   (8, 4, 4))
    smg = ShardedMultigrid(HaloVoxelOperator(op, L), smooth_iters=(1, 2))
    state, _ = smg.setup(L.split(s, "cell"), L.split(mask, "node"))
    assert smg._state is None
    R = L.split(r, "node")
    M = smg.make_M(state)
    assert not hasattr(M, "buffer")
    assert torch.equal(L.gather(M(R)), L.gather(smg._vcycle(0, state, R)))
    assert tracing.counters() == {"mg.graph.eager": 1}


@pytest.mark.parametrize("deflated", [False, True])
def test_cg_with_one_overwritten_buffer_is_bitwise(deflated):
    op, mask, (s, s1, s2), _ = _problem((16, 8, 8), torch.float32, seed=2)
    mg = MultigridPreconditioner(op, smooth_iters=(1, 2),
                                 cycle_dtype=torch.bfloat16)
    state, _ = mg.setup(s, mask)
    rng = np.random.default_rng(5)
    b = torch.tensor(rng.standard_normal(tuple(mask.shape)),
                     dtype=torch.float32) * mask
    x0 = 1e-2 * b
    ring = torch.stack([x0] + [x0 + 1e-3 * torch.tensor(
        rng.standard_normal(tuple(mask.shape)), dtype=torch.float32)
        for _ in range(3)])
    deflate = recycle_deflate(mask, ring) if deflated else None

    def A(v):
        return op.apply(v, s, mask)

    buf = torch.empty_like(b)
    calls = []

    def into_buffer(r):               # as the graph path: r in, M(r) out
        calls.append(r is buf)
        if r is not buf:
            buf.copy_(r)
        return mg._cycle(state, buf, out=buf)

    def M_buf(r):
        raise AssertionError("CG calls into_buffer where M offers it")

    M_buf.buffer, M_buf.into_buffer = buf, into_buffer
    want = cg_solve(A, b, x0=x0, M=lambda r: mg._cycle(state, r), rtol=1e-5,
                    maxiter=200, deflate=deflate)
    got = cg_solve(A, b, x0=x0, M=M_buf, rtol=1e-5, maxiter=200,
                   deflate=deflate)
    assert 3 <= want.iterations < 200
    assert got.iterations == want.iterations
    assert got.residual_norm == want.residual_norm
    assert torch.equal(got.u, want.u)
    assert torch.equal(got.u_dot_r, want.u_dot_r)
    # the first residual was computed into the buffer: undeflated, the
    # first call reads it in place
    assert calls[0] == (not deflated) and not any(calls[1:])


def test_replay_share_reader(monkeypatch):
    monkeypatch.setattr(tracing, "_counts", collections.Counter())
    assert mg_vcycle_replay_share.read(None) is None
    tracing.count("steps", 10)
    assert mg_vcycle_replay_share.read(None) is None
    tracing.count("mg.graph.capture")
    tracing.count("mg.graph.replay", 199)
    assert mg_vcycle_replay_share.read(None) == 100.0
    tracing.count("mg.graph.eager", 1)
    assert mg_vcycle_replay_share.read(None) == 99.5


def test_another_free_mask_leaves_the_own_state_pinned(monkeypatch):
    monkeypatch.setattr(tracing, "_counts", collections.Counter())
    op, mask, (sA, sB, _), r = _problem((16, 8, 8), torch.float64)
    mg = MultigridPreconditioner(op, smooth_iters=(1, 2))
    mg._on_card = lambda t: True
    own, _ = mg.setup(sA, mask)
    ptrs = [t.data_ptr() for t in _leaves(own)]
    want, _ = MultigridPreconditioner(op, smooth_iters=(1, 2)).setup(sA, mask)
    # an equal mask in another tensor: a fresh state, the own one untouched
    other, _ = mg.setup(sB, mask.clone())
    assert other is not own and mg._state is own
    _bitwise(own, want)
    M = mg.make_M(other)
    assert not hasattr(M, "into_buffer")
    assert torch.equal(M(r), mg._cycle(other, r))
    assert tracing.counters() == {"mg.graph.eager": 1}
    # the first mask again: the own state, refreshed in place
    again, _ = mg.setup(sB, mask)
    assert again is own and [t.data_ptr() for t in _leaves(own)] == ptrs
    _bitwise(own, other | {"masks": own["masks"]})


class _CountingStencils(MultigridPreconditioner):
    """Counts each coarse stencil apply as the CUDA wrapper counts its
    launches (a CPU apply counts none)."""

    def _stencil_apply(self, stencil, mask, v, r=None):
        tracing.count("launch.stencil_apply.test")
        return super()._stencil_apply(stencil, mask, v, r)


def _stand_in_capture(mg):
    """A stand-in for `_capture` on the CPU: the capture runs the cycle's
    Python (counting) but leaves the buffer as it was, as a capture
    launches nothing; a replay runs it without counting, as a replay runs
    no Python."""
    def capture(fn):
        kept = mg._buffer.clone()
        fn()
        mg._buffer.copy_(kept)

        def replay():
            counts = tracing._counts
            tracing._counts = collections.Counter()
            try:
                fn()
            finally:
                tracing._counts = counts

        return types.SimpleNamespace(replay=replay)

    return capture


def test_replays_count_the_launches_of_the_captured_cycle(monkeypatch):
    monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", "100")   # four levels
    monkeypatch.setattr(tracing, "_counts", collections.Counter())
    op, mask, (s, s1, _), r = _problem((16, 8, 8), torch.float32)
    kw = dict(smooth_iters=(1, 2), cycle_dtype=torch.bfloat16)
    mg = _CountingStencils(op, **kw)
    mg._on_card = lambda t: True
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(multigrid, "_capture", _stand_in_capture(mg))
    eager = _CountingStencils(op, **kw)
    state, _ = mg.setup(s, mask)
    fresh, _ = eager.setup(s, mask)
    setup_launches = tracing.counters()["launch.stencil_apply.test"]
    tracing._counts.clear()

    M, M_eager = mg.make_M(state), eager.make_M(fresh)
    first = M(r)                       # the eager answer, then the capture
    assert tracing.counters()["mg.graph.capture"] == 1
    per_cycle = tracing.counters()["launch.stencil_apply.test"]
    assert per_cycle > 0
    z1, z2 = M(r), M(2.0 * r)          # replays: tensors of their own
    zb = M.into_buffer(r)              # a replay into the buffer
    assert zb is M.buffer and z1 is not zb and z2 is not zb
    want = M_eager(r)
    for z in (first, z1, zb):
        assert torch.equal(z, want)
    assert torch.equal(z2, M_eager(2.0 * r))
    c = tracing.counters()
    assert c["mg.graph.replay"] == 3 and c["mg.graph.capture"] == 1
    # four M calls, eager or replayed, count four cycles' launches, as the
    # eager hierarchy's two calls count two
    assert c["launch.stencil_apply.test"] == 4 * per_cycle + 2 * per_cycle
    assert c["mg.graph.eager"] == 2
    assert c.get("sync.mg_capture") == 1
    # a refresh reaches the graph: the replay reads the refreshed state
    mg.setup(s1, mask)
    fresh1, _ = eager.setup(s1, mask)
    assert torch.equal(M(r), eager.make_M(fresh1)(r))
    assert setup_launches > 0


def test_stencil_roofline_reader(monkeypatch):
    monkeypatch.setattr(tracing, "_counts", collections.Counter())
    run = types.SimpleNamespace(trace=None)
    assert stencil_apply_roofline.read(run) is None
    run.trace = Trace(ops=[DeviceOp("void stencil_apply_kernel<float>", 0.0,
                                    dur, "", "") for dur in (40.0, 60.0)]
                      + [DeviceOp("voxel_matvec_tc", 100.0, 50.0, "", "")])
    assert stencil_apply_roofline.read(run) is None    # no counters
    tracing.count("launch.stencil_apply.float32", 3)
    tracing.count("launch.stencil_apply.bfloat16", 1)
    tracing.count("bytes.stencil_apply", 4 * 67_000_000)
    # two launches of 67 MB in 100 us
    want = 100.0 * 2 * 67e6 / HBM_BYTES_PER_S / 100e-6
    assert stencil_apply_roofline.read(run) == pytest.approx(want, rel=1e-12)
