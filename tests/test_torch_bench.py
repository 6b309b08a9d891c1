"""The port's bench (easysimp_tpu_torch/bench.py) against the JAX package's
`bench.py` on the CPU: the problem it builds, the stepper's host schedule,
the continuation prelude, and its command line in the voxel, unstructured
and sharded modes (one JSON line on stdout, no jax imported)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as bench_r
import easysimp_tpu as et
import easysimp_tpu_torch as pt
from easysimp_tpu_torch import bench as bench_p

ROOT = Path(__file__).resolve().parents[1]

VOXEL_KEYS = {
    "metric", "value", "unit", "avg_its", "avg_iters_timed",
    "avg_its_incl_prelude", "early_its", "early_cg", "late_its", "late_cg",
    "late_start_iter", "compile_s", "continuation", "prelude_iters",
    "prelude_s", "config", "hardware", "device"}

# runs the bench's command line, then reports whether jax or the JAX
# package was imported on the way
_RUN_BENCH = """
import runpy, sys
sys.argv = ["easysimp_tpu_torch.bench", "--device", "cpu"]
try:
    runpy.run_module("easysimp_tpu_torch.bench", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "easysimp_tpu"))
print("IMPORTED:", bad, file=sys.stderr, flush=True)
sys.exit(rc)
"""


def _bench_cli(env, merge=False):
    """(returncode, stdout, stderr) of the port's bench on the CPU; with
    `merge`, stderr goes into stdout in the order it was written."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_BENCH], cwd=ROOT, env=full,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT if merge else subprocess.PIPE,
        text=True, timeout=300)
    err = proc.stdout if merge else proc.stderr
    assert "IMPORTED: []" in err, err[-2000:]
    return proc.returncode, proc.stdout, err


def _one_json_line(stdout):
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, stdout
    payload = json.loads(lines[0])
    assert "vs_baseline" not in payload
    return payload


@pytest.fixture
def stepper_env(monkeypatch):
    """The float64 configuration both benches run in the parity tests: a
    three-level hierarchy, light setups between full ones every 3, and
    every solve pinned to 1e-10."""
    for key, value in {
            "BENCH_MG_DTYPE": "float64", "BENCH_RTOL_MAX": "1e-10",
            "BENCH_USE_PALLAS": "0", "EASYSIMP_MAX_COARSE_DOFS": "500",
            "BENCH_FULL_SETUP_EVERY": "3"}.items():
        monkeypatch.setenv(key, value)


def test_build_problem_matches_jax():
    """At 16x8x8 the port builds the JAX bench's free mask, load field,
    initial design and parameters."""
    nels = (16, 8, 8)
    _, vs_r, params_r = bench_r._build_problem(nels, "float64")
    grid_p, vs_p, params_p = bench_p._build_problem(nels, "float64", "cpu")
    _, loads_p, bcs_p = bench_p._cantilever(nels)
    f_ext, free_mask, _ = vs_r.step_args
    np.testing.assert_array_equal(pt.build_free_mask(grid_p, bcs_p),
                                  np.asarray(free_mask))
    np.testing.assert_array_equal(pt.build_load_field(grid_p, loads_p),
                                  np.asarray(f_ext))
    np.testing.assert_array_equal(vs_p.design0.numpy(),
                                  np.asarray(vs_r.design0))
    assert params_p.__dict__ == params_r.__dict__
    assert (params_p.cg_rtol, params_p.cg_maxiter, params_p.mg_cycle_dtype,
            params_p.mg_smooth_iters, params_p.mg_refresh_iters) == \
        (1e-5, 500, "bfloat16", (1, 2), 2)


def test_stepper_matches_jax(stepper_env):
    """The port's _Stepper against the JAX _Stepper (its CPU path, no
    Pallas) for 8 iterations at 16x8x8 float64: setup cadence, watchdog,
    recycle ring of 8 and the adaptive tolerance; energies rtol 1e-8, CG
    counts within 1 (tests/test_torch_optimize.py::
    test_light_setup_cadence_matches_jax)."""
    kw = dict(recycle_k=8, adaptive=True, setup_every=1)
    _, vs_r, params_r = bench_r._build_problem((16, 8, 8), "float64")
    st_r = bench_r._Stepper(vs_r, params_r, **kw)
    _, vs_p, params_p = bench_p._build_problem((16, 8, 8), "float64", "cpu")
    st_p = bench_p._Stepper(vs_p, params_p, **kw)
    assert vs_p.precond.n_levels == 3 and st_p.light_ok
    st_r.cold_power()
    st_p.cold_power()
    got, want = [], []
    for _ in range(8):
        e, c = st_r.one_step()
        want.append((float(e), int(c)))
        e, c = st_p.one_step()
        got.append((float(e), c))
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=0, atol=1)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-8)
    assert float(st_p.rtol_now) == float(st_r.rtol_now) == 1e-10


def test_simp_optimize_runs_the_bench_schedule(stepper_env, monkeypatch):
    """`simp_optimize` steps the schedule that the bench's _Stepper steps:
    at 16x8x8 float64 in the bench's composition, with a full setup every
    3 (the stepper's from BENCH_FULL_SETUP_EVERY, the optimizer's from
    mg_full_setup_every while BENCH_FULL_SETUP_EVERY says 5), bitwise-equal
    energies and CG counts over 8 iterations."""
    nels = (16, 8, 8)
    grid, vs, params = bench_p._build_problem(nels, "float64", "cpu")
    st = bench_p._Stepper(vs, params, recycle_k=8, adaptive=True,
                          setup_every=1)
    assert st.full_every == 3 and st.light_ok
    st.cold_power()
    want = []
    for _ in range(8):
        energy, cg = st.one_step()
        want.append((float(energy), cg))
    monkeypatch.setenv("BENCH_FULL_SETUP_EVERY", "5")
    _, loads, bcs = bench_p._cantilever(nels)
    res = pt.simp_optimize(grid, loads, bcs, dataclasses.replace(
        params, cg_recycle_k=8, cg_forcing="adaptive", mg_setup_every=1,
        mg_full_setup_every=3, max_iterations=8, tolerance=0.0),
        device="cpu")
    assert list(zip(res.energy_history, res.cg_iterations_history)) == want


def test_continuation_init_matches_jax(monkeypatch):
    """The prelude at (32,16,16), 3 coarse iterations at the bench's own
    tolerances: prolonged design and displacements rtol 1e-8 of the JAX
    bench's, the same carried CG tolerance."""
    monkeypatch.setenv("BENCH_MG_DTYPE", "float64")
    monkeypatch.setenv("BENCH_USE_PALLAS", "0")
    kw = dict(recycle_k=8, adaptive=True, setup_every=1, n_iters=3)
    d_r, u_r, rtol_r, _, e_r = bench_r._continuation_init(
        (32, 16, 16), "float64", **kw)
    d_p, u_p, rtol_p, _, e_p = bench_p._continuation_init(
        (32, 16, 16), "float64", "cpu", **kw)
    assert tuple(d_p.shape) == (32, 16, 16)
    assert tuple(u_p.shape) == (33, 17, 17, 3)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), rtol=1e-8,
                               atol=1e-12)
    u_r = np.asarray(u_r)
    np.testing.assert_allclose(u_p.numpy(), u_r, rtol=1e-8,
                               atol=1e-8 * np.abs(u_r).max())
    assert float(rtol_p) == float(rtol_r)
    np.testing.assert_allclose(e_p, e_r, rtol=1e-8)


def test_cli_voxel_line():
    """`python -m easysimp_tpu_torch.bench --device cpu` at 16x8x8: stdout
    is exactly one JSON line with the bench's keys, no `vs_baseline`, and
    neither jax nor the JAX package is imported."""
    rc, out, err = _bench_cli({
        "BENCH_NELS": "16,8,8", "BENCH_ITERS": "2", "BENCH_LATE_START": "6",
        "BENCH_CONTINUATION": "0"})
    assert rc == 0, err[-2000:]
    line = _one_json_line(out)
    assert set(line) == VOXEL_KEYS
    assert line["metric"] == "simp_iterations_per_sec_16x8x8"
    assert line["avg_iters_timed"] == 2 + 3 + 2
    assert line["value"] == line["avg_its"] > 0
    assert line["hardware"] == "cpu" and line["device"] == "cpu"
    assert line["continuation"] is False and line["prelude_iters"] == 0
    assert 0 < line["early_cg"] < 500 and 0 < line["late_cg"] < 500
    assert line["config"]["full_setup_every"] == 4


def test_cli_phases_follow_the_line():
    """BENCH_PHASES=1 prints the phase rows after the JSON line."""
    rc, out, _ = _bench_cli({
        "BENCH_NELS": "16,8,8", "BENCH_ITERS": "1", "BENCH_SKIP_LATE": "1",
        "BENCH_CONTINUATION": "0", "BENCH_PHASES": "1"}, merge=True)
    assert rc == 0, out[-2000:]
    lines = out.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.startswith("{")]
    assert len(at) == 1
    json.loads(lines[at[0]])
    header = lines.index("--- phase breakdown (ms) ---")
    assert header > at[0]
    rows = "\n".join(lines[header:])
    for row in ("matvec (K@u)", "element energies", "sensitivity filter",
                "OC bisection", "setup (full)",
                "step (CG, sensitivities, OC)"):
        assert row in rows


def test_measurement_trajectory(monkeypatch):
    """run_measurement in process with a continuation prelude (32^3, a
    prelude of 3 iterations at 16^3): every iteration's energy is finite,
    the design keeps the volume fraction 0.3, and the counts add up."""
    for key, value in {"BENCH_NELS": "32,32,32", "BENCH_ITERS": "2",
                       "BENCH_LATE_START": "5", "BENCH_PRELUDE_ITERS": "3",
                       "BENCH_DTYPE": "float64"}.items():
        monkeypatch.setenv(key, value)
    run = bench_p.run_measurement("cpu")
    line = run.payload
    assert set(line) == VOXEL_KEYS
    assert line["continuation"] is True and line["prelude_iters"] == 3
    assert len(run.energies) == len(run.cgs) == 1 + 2 + 2 + 2
    assert line["avg_iters_timed"] == 6
    assert all(np.isfinite(run.energies))
    assert abs(run.volume_fraction - 0.3) < 1e-6
    assert line["early_cg"] == run.cgs[2] and line["late_cg"] == run.cgs[-1]


def test_cli_unstructured_matches_jax(monkeypatch):
    """BENCH_UNSTRUCTURED=6: one JSON line from the command line, and the
    energy history of the same run (float64, every solve at 1e-10) equal
    to the JAX package's simp_optimize on the same tet mesh, whose
    loop the JAX bench mirrors (rtol 1e-8, CG counts equal)."""
    env = {"BENCH_UNSTRUCTURED": "6", "BENCH_DTYPE": "float64",
           "BENCH_ITERS": "2", "BENCH_LATE_START": "4",
           "BENCH_RTOL_MAX": "1e-10"}
    rc, out, err = _bench_cli(env)
    assert rc == 0, err[-2000:]
    line = _one_json_line(out)
    assert line["metric"] == "simp_iterations_per_sec_unstructured_tet6"
    assert line["cells"] == 6 ** 3 * 6 and line["hardware"] == "cpu"
    assert line["avg_iters_timed"] == 5

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    run = bench_p.run_unstructured("6", device="cpu")
    from easysimp_tpu.mesh import tet_mesh_from_grid

    n = 6
    mesh = tet_mesh_from_grid(et.generate_grid((n, n, n), (0.0, 0.0, 0.0),
                                               (float(n),) * 3))
    bc = et.apply_fixed_boundary(
        mesh, et.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    load = et.PointLoad(
        et.select_nodes_by_box(mesh, [n, 0, 0], [n, 0, n], 1e-6),
        [0.0, -1.0, 0.0])
    params = et.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.3,
        filter_radius=1.5, dtype="float64", cg_rtol=1e-5, cg_rtol_max=1e-10,
        cg_maxiter=2000, cg_recycle_k=8, cg_forcing="adaptive",
        amg_smooth_prolongator=False, amg_max_coarse_dofs=6000,
        max_iterations=len(run.energies), tolerance=0.0)
    ref = et.simp_optimize(mesh, [load], [bc], params)
    assert run.cgs == ref.cg_iterations_history
    np.testing.assert_allclose(run.energies, ref.energy_history, rtol=1e-8)


def test_cli_sharded_counts_and_energy():
    """BENCH_SHARDED=4 on four CPU shards at 8x8x8: halo copies and global
    reductions counted, and the step's energy equal to the unsharded port
    step's (float64, rtol 1e-10, CG equal)."""
    rc, out, err = _bench_cli({"BENCH_SHARDED": "4",
                               "BENCH_NELS": "8,8,8",
                               "BENCH_DTYPE": "float64"})
    assert rc == 0, err[-2000:]
    line = _one_json_line(out)
    assert line["metric"] == "sharded_step_collectives_4dev_8x8x8"
    assert line["halo_copies"] > 0 and line["reductions"] > 0
    assert line["value"] == line["halo_copies"] + line["reductions"]
    vs, _ = bench_p.sharded_problem((8, 8, 8), "float64", "cpu")
    one = bench_p.first_step(vs)
    assert line["cg_iters"] == one.cg_iters < 100
    np.testing.assert_allclose(line["energy"], float(one.energy),
                               rtol=1e-10)


@pytest.mark.parametrize("name", ["run_measurement", "run_unstructured",
                                  "run_sharded_evidence", "main"])
def test_entry_points_default_to_cuda(name):
    """Every mode defaults to device="cuda" and, without a CUDA device,
    raises before it builds anything (as tests/test_torch_models.py::
    test_entry_points_default_to_cuda)."""
    import inspect

    calls = {
        "run_measurement": (bench_p.run_measurement,
                            lambda: bench_p.run_measurement()),
        "run_unstructured": (bench_p.run_unstructured,
                             lambda: bench_p.run_unstructured("4")),
        "run_sharded_evidence": (bench_p.run_sharded_evidence,
                                 lambda: bench_p.run_sharded_evidence(2)),
        "main": (None, lambda: bench_p.main([])),
    }
    fn, call = calls[name]
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
