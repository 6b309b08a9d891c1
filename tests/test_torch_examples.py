"""The port's example scripts (easysimp_tpu_torch/examples/) against the
JAX package's (examples/): each imports neither jax nor the JAX package,
defaults to the card, and, run on the CPU at a reduced size and iteration
count (the model's build function patched alike on both sides), gives the
JAX example's energy history at the tolerances of
tests/test_torch_models.py."""

import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu.models import cantilever as cant_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.models import cantilever as cant_p

ROOT = Path(__file__).resolve().parents[1]
REF_DATA = os.environ.get("EASYSIMP_REFERENCE_DATA", "")
NAMES = sorted(p.stem for p in (ROOT / "examples").glob("[01]*.py"))
# float64, tight Jacobi solves: the runs of tests/test_torch_models.py
RUN = dict(max_iterations=3, dtype="float64", cg_rtol=1e-12,
           preconditioner="jacobi")


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"example_reference_{name[:2]}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(name):
    return importlib.import_module(f"easysimp_tpu_torch.examples.{name}")


def _small(build, **fixed):
    """`build` with the reduced run's overrides on top of its caller's."""
    def small(*a, **kw):
        return build(*a, **{**kw, **RUN, **fixed})
    return small


@pytest.fixture(scope="module")
def imported():
    """{example: modules of jax or the JAX package imported by it}, each
    imported in turn in one fresh interpreter."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name in {NAMES!r}:\n"
        "    importlib.import_module('easysimp_tpu_torch.examples.' + name)\n"
        "    out[name] = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                      in ('jax', 'jaxlib', 'easysimp_tpu'))\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)},
                          capture_output=True, text=True, timeout=300,
                          check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_example_has_its_twin():
    assert len(NAMES) == 11
    port = sorted(p.stem for p in
                  (ROOT / "easysimp_tpu_torch" / "examples").glob("[01]*.py"))
    assert port == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_no_jax(name, imported):
    assert imported[name] == []


@pytest.mark.parametrize("name,build", [
    ("01_basic_cantilever", "build_basic"),
    ("02_sliding_support", "build_sliding"),
    ("03_with_acceleration", "build_acceleration"),
])
def test_cantilever_examples_match(name, build, monkeypatch, tmp_path):
    """01-03 at 12x4x2 for 3 iterations: energies rtol 1e-8, densities
    atol 1e-7 of the JAX example's run; the exports land in results_dir."""
    monkeypatch.setattr(cant_r, build, _small(getattr(cant_r, build),
                                              nels=(12, 4, 2)))
    monkeypatch.setattr(cant_p, build, _small(getattr(cant_p, build),
                                              nels=(12, 4, 2)))
    want = _reference(name).main(str(tmp_path / "r"))
    got = _port(name).main(str(tmp_path / "p"), device="cpu")
    assert got.iterations == want.iterations == 3
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(got.densities, want.densities, atol=1e-7)
    assert (tmp_path / "p" / "optimization_progress.csv").exists()
    if name == "01_basic_cantilever":
        assert (tmp_path / "p" / "final_results.vtu").exists()


def test_tolerance_study_example_matches(monkeypatch, tmp_path):
    """05 with two tolerances at 8x4x4 (3 iterations each, after the
    warmup run): the same rows as the JAX example's, energies rtol 1e-8."""
    rows = {}
    for side, module in (("r", _reference("05_3D_2x1x1_4Legs_tol_study")),
                         ("p", _port("05_3D_2x1x1_4Legs_tol_study"))):
        monkeypatch.setattr(module, "DEFAULT_TOLERANCES", (0.16, 0.08))
        monkeypatch.setattr(module, "build_four_legs",
                            _small(module.build_four_legs, nels=(8, 4, 4)))
        kw = {"device": "cpu"} if side == "p" else {}
        rows[side] = module.main(str(tmp_path / side), **kw)
    assert [r["tolerance"] for r in rows["p"]] == [0.16, 0.08]
    for got, want in zip(rows["p"], rows["r"]):
        assert got["iterations"] == want["iterations"]
        assert got["converged"] == want["converged"]
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-8)
        np.testing.assert_allclose(got["volume_fraction"],
                                   want["volume_fraction"], rtol=1e-10)
    assert (tmp_path / "p" / "05_4legs_batch_summary.txt").exists()


def test_sharded_example_matches(monkeypatch, tmp_path):
    """10 at 16x8x4 on four CPU shards (the JAX example on its eight
    virtual devices): energies rtol 1e-8 of the JAX example's run."""
    monkeypatch.setattr(cant_r, "build_basic", _small(cant_r.build_basic))
    monkeypatch.setattr(cant_p, "build_basic", _small(cant_p.build_basic))
    want = _reference("10_sharded_cantilever").main(16, 8, 4)
    got = _port("10_sharded_cantilever").main(16, 8, 4, device="cpu",
                                              shards=4)
    assert got.iterations == want.iterations == 3
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)


def test_tuned_example_matches(monkeypatch, tmp_path):
    """11 at 16x8x8 with its multigrid, recycling and adaptive forcing, in
    float64 with a float64 cycle and every solve at 1e-10 (both sides
    patched alike; the checkpoint goes to tmp_path): energies rtol 1e-8."""
    monkeypatch.chdir(tmp_path)
    over = dict(dtype="float64", mg_cycle_dtype="float64", cg_rtol=1e-12,
                cg_rtol_max=1e-10, checkpoint_interval=2,
                checkpoint_path=str(tmp_path / "ckpt.npz"))
    results = {}
    for side, pkg, models in (("r", et, cant_r), ("p", pt, cant_p)):
        module = (_reference("11_performance_tuned") if side == "r"
                  else _port("11_performance_tuned"))
        cls = pkg.OptimizationParameters
        monkeypatch.setattr(module, "OptimizationParameters",
                            lambda cls=cls, **kw: cls(**{**kw, **over}))
        monkeypatch.setattr(models, "build_basic", lambda build=getattr(
            models, "build_basic"), **kw: build(**{**kw,
                                                   "max_iterations": 4}))
        kw = {"device": "cpu"} if side == "p" else {}
        results[side] = module.main(16, 8, 8, **kw)
    got, want = results["p"], results["r"]
    assert got.iterations == want.iterations == 4
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)
    assert (tmp_path / "ckpt.npz").exists()


@pytest.mark.parametrize("name,model,fname", [
    ("04_gripper_complex", "gripper", "stul14.vtu"),
    ("09_wheel_traction", "wheel", "Wheel_3d_coarse.msh"),
])
def test_imported_mesh_examples_match(name, model, fname, monkeypatch,
                                      tmp_path):
    """04 and 09 on the reference's mesh files, which this repository does
    not hold: skipped unless EASYSIMP_REFERENCE_DATA names their directory
    (as tests/test_torch_mesh.py); 2 iterations, energies rtol 1e-6."""
    path = os.path.join(REF_DATA, fname)
    if not (REF_DATA and os.path.exists(path)):
        pytest.skip("reference mesh files unavailable")
    mod_r = importlib.import_module(f"easysimp_tpu.models.{model}")
    mod_p = importlib.import_module(f"easysimp_tpu_torch.models.{model}")
    build_r, build_p = mod_r.build, mod_p.build
    monkeypatch.setattr(mod_r, "build", lambda **kw: build_r(
        mesh_path=path, **{**kw, "max_iterations": 2}))
    monkeypatch.setattr(mod_p, "build", lambda mesh_path, **kw: build_p(
        mesh_path, **{**kw, "max_iterations": 2}))
    want = _reference(name).main(str(tmp_path / "r"))
    got = _port(name).main(path, str(tmp_path / "p"), device="cpu")
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_cuda(name, monkeypatch, tmp_path):
    """Every example's `main` defaults to device="cuda" and, without a CUDA
    device, raises (the imported-mesh ones: the signature only, since
    their mesh files are not in this repository)."""
    module = _port(name)
    assert inspect.signature(module.main).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available() or name[:2] in ("04", "09"):
        return
    monkeypatch.chdir(tmp_path)   # the default results directories
    for build in ("build_basic", "build_sliding", "build_acceleration"):
        monkeypatch.setattr(cant_p, build, _small(getattr(cant_p, build),
                                                  nels=(4, 2, 2)))
    for attr in ("build_four_legs", "build_mbb", "build_michell",
                 "build_michell_half"):
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, _small(getattr(module, attr),
                                                     nels=(4, 2, 2)))
            monkeypatch.setattr(module, "DEFAULT_TOLERANCES", (0.5,))
    args = (4, 2, 2) if name[:2] in ("10", "11") else ()
    with pytest.raises((AssertionError, RuntimeError)):
        module.main(*args)
