"""CPU tests of the benchmark at tiny sizes (8^3 voxels, 4^3 x 6 tets; the
cold cell's control at 16^3), with the program's plain kernels:

    python -m pytest simpbench/tests -q -p no:cacheprovider --noconftest

(--noconftest: the repository's root conftest.py imports JAX, which the
benchmark must never load.)  Card checks run through the harness command.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simpbench import (calibrate, cells, check, faults, reference, roofline,
                       run, systems)
from simpbench import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = cells.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"cantilever128-cold": [8, 8, 8],
        "cantilever128-developed": [8, 8, 8],
        "tet44-cold": [4, 4, 4]}
torch.set_num_threads(2)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(name):
    return cells.load_cell(name, overrides={"nels": TINY[name]})


def run_main(name, seed=5, trace=0, seconds=0.5):
    """run.main on the CPU at the cell's tiny size: (exit code, last
    stdout line as a dict or None)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace),
                       "--device", "cpu"], overrides={"nels": TINY[name]})
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


# --------------------------------------------------------------------------
# the files, found by name
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = cells.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.chips == 1
    assert {"residual", "design_gap", "start_gap"} <= set(cell.limits)
    assert set(cell.limits) <= set(check.NUMBERS) | {"start_gap"}
    names = [m["name"] for m in cell.metrics]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.metrics + cell.per_layer:
        assert callable(cells.reader(m["name"]).read)
    assert cell.config["kind"] in reference.PROBLEMS


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["simpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("simpbench/") and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


# --------------------------------------------------------------------------
# the seed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 33 + 5])
@pytest.mark.parametrize("config", ["cantilever128", "tet44"])
def test_start_design_keeps_the_volume_fraction(config, seed):
    cfg = cells.load_json(cells.HERE / "configs" / f"{config}.json")
    vf = cfg["params"]["volume_fraction"]
    amp = cfg["seed_perturbation"]["amplitude"]
    x = cells.start_design(cfg, seed, (10, 9, 8))
    assert abs(x.mean() - vf) < 1e-12
    assert np.abs(x - vf).max() <= 2 * amp and np.abs(x - vf).max() > amp / 2
    assert np.array_equal(x, cells.start_design(cfg, seed, (10, 9, 8)))
    assert not np.array_equal(x, cells.start_design(cfg, seed + 1,
                                                    (10, 9, 8)))
    x32 = torch.as_tensor(x, dtype=torch.float32).double().mean().item()
    assert abs(x32 - vf) < 1e-7


# --------------------------------------------------------------------------
# the yardstick's arithmetic
# --------------------------------------------------------------------------

def test_matvec_bound_at_128():
    """PERF.md's byte bounds of voxel_matvec at 128^3 from the shapes and
    the published 3.35 TB/s."""
    f32, by32 = roofline.voxel_matvec_seconds((128, 128, 128), "float32")
    b16, by16 = roofline.voxel_matvec_seconds((128, 128, 128), "bfloat16")
    assert by32 == by16 == "bytes"
    assert round(f32 * 1e3, 4) == 0.0179 and round(b16 * 1e3, 4) == 0.0089
    assert roofline.voxel_matvec_bytes((128, 128, 128), "bfloat16") \
        == 29_956_876


def _chrome(tmp_path):
    """A synthetic trace: two spans on the host, three kernels."""
    ev = [
        {"cat": "user_annotation", "name": "simpbench:setup", "ts": 0,
         "dur": 10, "tid": 1},
        {"cat": "user_annotation", "name": "simpbench:step", "ts": 10,
         "dur": 30, "tid": 1},
        {"cat": "cpu_op", "name": "aten::mul", "ts": 1, "dur": 3, "tid": 1},
        {"cat": "cpu_op", "name": "aten::add", "ts": 20, "dur": 3, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2,
         "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 21,
         "dur": 1, "tid": 1, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30,
         "dur": 1, "tid": 1, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "void voxel_matvec_tc<float>(int)",
         "ts": 5, "dur": 10, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "void voxel_matvec_tc<__nv_bfloat16>(int)",
         "ts": 12, "dur": 8, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 5,
         "args": {"correlation": 3}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.parse_chrome_trace(path)


def test_trace_arithmetic(tmp_path):
    t = _chrome(tmp_path)
    assert t.busy_us() == 20.0                 # [5, 20] and [30, 35]
    assert [op.span for op in t.ops] == ["setup", "step", "step"]
    assert t.ops[0].launched_by == "aten::mul"
    assert t.ops[1].launched_by == "aten::add"
    assert t.gaps() == [("step", 10.0)]
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["void voxel_matvec_tc<float>(int)", 1e-5]
    assert b["idle_gaps"] == [["step", 1e-5]]


def test_layer_readers(tmp_path):
    r = run.Run(cells.load_cell("cantilever128-cold"))
    r.trace, r.trace_window_s, r.traced_iterations = _chrome(tmp_path), 4e-5, 2
    r.cg = [3, 5]
    get = {n: cells.reader(n).read(r) for n in
           ("device_idle_pct", "mg_setup_ms", "cg_per_iteration",
            "voxel_matvec_roofline")}
    assert math.isclose(get["device_idle_pct"], 50.0)
    assert math.isclose(get["mg_setup_ms"], 10e-3 / 2)
    assert get["cg_per_iteration"] == 4.0
    bound = sum(roofline.voxel_matvec_seconds((128,) * 3, d)[0]
                for d in ("float32", "bfloat16"))
    assert math.isclose(get["voxel_matvec_roofline"], 100 * bound / 18e-6)
    empty = run.Run(r.cell)
    assert all(cells.reader(n).read(empty) is None for n in
               ("device_idle_pct", "mg_setup_ms", "voxel_matvec_roofline"))


# --------------------------------------------------------------------------
# the reference against the port's float64 semantics
# --------------------------------------------------------------------------

def test_voxel_reference_agrees_with_the_port():
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.ops.filters import VoxelFilter
    from easysimp_tpu_torch.ops.operator import VoxelOperator

    cell = tiny("cantilever128-cold")
    nels = (5, 4, 3)
    P = reference.problem(cell.config, nels, "cpu")
    grid = pt.generate_grid(nels)
    op = VoxelOperator(grid, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(0)
    u = torch.rand((6, 5, 4, 3), generator=g, dtype=torch.float64)
    x = torch.rand(nels, generator=g, dtype=torch.float64) * 0.9 + 0.05
    E = P.modulus(x)
    assert torch.allclose(P.apply_K(u, E), op.apply_K(u, op.youngs_modulus(x)),
                          rtol=1e-12, atol=1e-12)
    assert torch.allclose(P.energies(u), op.element_energies_unit(u),
                          rtol=1e-12, atol=1e-12)
    filt = VoxelFilter(grid, 1.5, dtype=torch.float64, device="cpu")
    s = -torch.rand(nels, generator=g, dtype=torch.float64)
    assert torch.allclose(P.sensitivity_filter(x, s),
                          filt.sensitivity_filter(x, s), rtol=1e-12)


def test_tet_reference_agrees_with_the_port():
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.ops.filters import create_filter_cache
    from easysimp_tpu_torch.opt.optimize_unstructured import (
        build_unstructured_step,
    )

    cell = tiny("tet44-cold")
    nels = (4, 3, 3)
    P = reference.problem(cell.config, nels, "cpu")
    mesh = pt.tet_mesh_from_grid(pt.generate_grid(nels))
    assert np.array_equal(P.coords, mesh.node_coords)
    assert np.array_equal(P.conn, mesh.connectivity)
    params = systems.make_params(pt, {**cell.config, "params": {
        **cell.config["params"], "dtype": "float64"}})
    us = build_unstructured_step(mesh, [], [], params, device="cpu")
    g = torch.Generator().manual_seed(1)
    u = torch.rand(mesh.n_dofs, generator=g, dtype=torch.float64)
    x = torch.rand(mesh.n_cells, generator=g, dtype=torch.float64) * 0.9 + .05
    E = P.modulus(x)
    assert torch.allclose(P.apply_K(u, E), us.op.apply_K(u, E), rtol=1e-12,
                          atol=1e-12)
    filt = create_filter_cache(mesh, 1.5, dtype=torch.float64, device="cpu")
    s = -torch.rand(mesh.n_cells, generator=g, dtype=torch.float64)
    assert torch.allclose(P.sensitivity_filter(x, s),
                          filt.sensitivity_filter(x, s), rtol=1e-12)


# --------------------------------------------------------------------------
# episodes, the result line, the modules loaded
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cantilever128-cold", "tet44-cold"])
def test_two_episodes_repeat(name):
    cell = tiny(name)
    system = systems.build(cell, "cpu")
    system.prepare(3, [])
    runs = []
    for _ in range(2):
        system.restore()
        runs.append([(float(e), c) for e, c in
                     (system.one_step() for _ in range(
                         cell.traffic["episode_iterations"]))])
    assert runs[0] == runs[1]
    assert all(math.isfinite(e) and c > 0 for e, c in runs[0])


def test_developed_episodes_repeat():
    cell = tiny("cantilever128-developed")
    system = systems.build(cell, "cpu")
    records = []
    system.prepare(3, records)
    assert [r.get("exact", r["level"]) for r in records] == \
        ["start_design", 1, "prolonged_design", 0, 0]
    runs = []
    for _ in range(2):
        system.restore()
        runs.append([(float(e), c) for e, c in
                     (system.one_step() for _ in range(10))])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    rc, out = run_main(name, seed=2 ** 31 + 3, trace=trace)
    assert rc == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(out) == keys + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % cells.load_cell(name).traffic[
        "episode_iterations"] == 0
    want = {m["name"] for m in (tiny(name).per_layer if trace
                                else tiny(name).metrics)}
    # device metrics have nothing to read on the CPU and stay out
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    assert list(out["checks"]) == list(tiny(name).limits)


def test_no_jax_module_is_loaded():
    code = ("import sys; from simpbench import run; "
            "rc = run.main(['--workload', 'tet44-cold', '--seed', '1', "
            "'--seconds', '0.1', '--device', 'cpu'], "
            "overrides={'nels': [4, 4, 4]}); "
            "print('LOADED', run.forbidden_modules()); sys.exit(rc)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "LOADED []" in p.stdout
    code = ("import sys, types; from simpbench import run; "
            "sys.modules['easysimp_tpu_torch_x'] = types.ModuleType('a'); "
            "assert run.forbidden_modules() == []; "
            "sys.modules['easysimp_tpu.ops'] = types.ModuleType('b'); "
            "print(run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.stdout.strip() == "['easysimp_tpu']", p.stderr[-2000:]


def test_exits_without_a_card_or_the_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "simpbench/run.py", "--workload",
                        "tet44-cold", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env=env)
    assert p.returncode != 0 and p.stdout == ""
    # a directory holding only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "simpbench", tmp_path / "simpbench")
    p = subprocess.run([sys.executable, "simpbench/run.py", "--workload",
                        "tet44-cold", "--seed", "1", "--seconds", "1",
                        "--device", "cpu"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout == ""


# --------------------------------------------------------------------------
# the control and the faults come out not correct
# --------------------------------------------------------------------------

# sizes at which the TF32 control already reads past a committed limit
CONTROL_NELS = {"cantilever128-cold": [16, 16, 16],
                "cantilever128-developed": [8, 8, 8],
                "tet44-cold": [4, 4, 4]}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control (the reference in the program's place, in TF32) comes
    out not correct, and the program correct, under the cell's committed
    limits, judged as calibrate.py judges them on the card."""
    cell = cells.load_cell(name, overrides={"nels": CONTROL_NELS[name]})
    system = systems.build(cell, "cpu")
    prog, info = calibrate.program_records(
        system, 11, cell.traffic["episode_iterations"])
    line = calibrate.reading(cell, "program", 11, prog, info, "cpu", 0.0)
    assert line["correct"] is True, line["checks"]
    ctrl, info = calibrate.control_records(cell, system, 11, "cpu")
    line = calibrate.reading(cell, "control", 11, ctrl, info, "cpu", 0.0)
    assert line["correct"] is False, line["checks"]


FAULTS = [(name, fault) for name in CELLS
          for fault in faults.for_cell(cells.load_cell(name))]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    """A whole run at the tiny size with the fault planted under the
    harness comes out not correct."""
    cls = importlib.import_module(
        f"simpbench.systems.{tiny(name).config['kind']}").System
    monkeypatch.setattr(cls, "one_step", faults.FAULTS[fault](cls.one_step))
    rc, out = run_main(name, seed=9)
    assert rc == 0 and out["correct"] is False, out["checks"]


def test_faults_through_calibrate():
    """calibrate.py's fault readings: one start state, each fault planted
    in turn and taken out again."""
    cell = tiny("tet44-cold")
    system = systems.build(cell, "cpu")
    out = calibrate.fault_records(system, 4, 5, faults.for_cell(cell))
    assert list(out) == faults.for_cell(cell) and "one_step" not in vars(
        system)
    for name, (records, info) in out.items():
        line = calibrate.reading(cell, "fault", 4, records, info, "cpu", 0.0,
                                 fault=name)
        assert line["correct"] is False and line["fault"] == name
