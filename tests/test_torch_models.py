"""The port's voxel models (models/cantilever.py, models/beam_2x1x1.py,
models/tol_study.py) and its FD verifier against the JAX package's, float64
on the CPU at small grids."""

import numpy as np
import pytest

import easysimp_tpu as et
from easysimp_tpu.models import beam_2x1x1 as beam_r
from easysimp_tpu.models import cantilever as cant_r
from easysimp_tpu.opt.verify_sensitivities import verify_sensitivities \
    as verify_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch.models import beam_2x1x1 as beam_p
from easysimp_tpu_torch.models import cantilever as cant_p
from easysimp_tpu_torch.models import tol_study

_VARIANTS = [
    (cant_r, cant_p, "basic", (12, 4, 2)),
    (cant_r, cant_p, "sliding", (12, 4, 2)),
    (cant_r, cant_p, "acceleration", (12, 4, 2)),
    (beam_r, beam_p, "four_legs", (8, 4, 4)),
    (beam_r, beam_p, "mbb", (8, 4, 4)),
    (beam_r, beam_p, "michell", (8, 4, 4)),
    (beam_r, beam_p, "michell_half", (8, 4, 4)),
]
_RUN = dict(max_iterations=3, tolerance=1e-9, dtype="float64",
            cg_rtol=1e-12, preconditioner="jacobi")


@pytest.mark.parametrize("mod_r,mod_p,variant,nels", _VARIANTS,
                         ids=[v[2] for v in _VARIANTS])
def test_model_matches_reference(mod_r, mod_p, variant, nels):
    """Each variant builds exactly the JAX package's free mask, load field,
    parameters and body force, and its 3-iteration run through `run`
    matches at rtol 1e-8."""
    grid_r, loads_r, bcs_r, params_r, accel_r = getattr(
        mod_r, f"build_{variant}")(nels=nels)
    grid_p, loads_p, bcs_p, params_p, accel_p = getattr(
        mod_p, f"build_{variant}")(nels=nels)
    np.testing.assert_array_equal(pt.build_free_mask(grid_p, bcs_p),
                                  et.build_free_mask(grid_r, bcs_r))
    np.testing.assert_array_equal(pt.build_load_field(grid_p, loads_p),
                                  et.build_load_field(grid_r, loads_r))
    assert params_p.__dict__ == params_r.__dict__
    assert accel_p == accel_r

    want = mod_r.run(variant, nels=nels, **_RUN)
    got = mod_p.run(variant, device="cpu", nels=nels, **_RUN)
    assert got.iterations == want.iterations == 3
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-8)
    np.testing.assert_allclose(got.densities, want.densities, atol=1e-7)


def _entry_points():
    from easysimp_tpu_torch.opt.continuation import continuation_init

    small = dict(nels=(4, 2, 2), max_iterations=1)
    problem = cant_p.build_basic(**small)[:4]
    return {
        "cantilever.run": (cant_p.run, lambda: cant_p.run("basic", **small)),
        "beam_2x1x1.run": (beam_p.run, lambda: beam_p.run("mbb", **small)),
        "run_tolerance_study": (
            tol_study.run_tolerance_study,
            lambda: tol_study.run_tolerance_study(
                cant_p.build_basic, tolerances=(0.5,), **small)),
        "verify_sensitivities": (
            pt.verify_sensitivities,
            lambda: pt.verify_sensitivities(*problem, n_elements=1)),
        "continuation_init": (continuation_init,
                              lambda: continuation_init(*problem)),
    }


@pytest.mark.parametrize("name", ["cantilever.run", "beam_2x1x1.run",
                                  "run_tolerance_study",
                                  "verify_sensitivities",
                                  "continuation_init"])
def test_entry_points_default_to_cuda(name):
    """The new entry points default to device="cuda" too: without a CUDA
    device a call that names no device raises (as
    tests/test_torch_kernels.py::test_entry_points_default_to_cuda)."""
    import inspect

    import torch

    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        call()
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_verify_sensitivities_matches_reference():
    """The FD table: max rel err < 1e-3, negative sensitivities, and the
    JAX package's table at 1e-6."""
    args_r = cant_r.build_basic(nels=(6, 3, 2))[:4]
    args_p = cant_p.build_basic(nels=(6, 3, 2))[:4]
    want = verify_r(*args_r, n_elements=4, perturbation=1e-6)
    got = pt.verify_sensitivities(*args_p, n_elements=4, perturbation=1e-6,
                                  device="cpu")
    assert np.all(got[2] < 1e-3) and np.all(got[0] < 0)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    rho = np.random.default_rng(0).uniform(0.2, 0.9, (6, 3, 2))
    got = pt.verify_sensitivities(*args_p, n_elements=3, densities=rho,
                                  device="cpu")
    assert np.all(got[2] < 1e-3)


def test_tolerance_study(tmp_path):
    """The ladder runs once per tolerance after an untimed warmup, writes
    each run's log under its own folder and the batch table."""
    rows = tol_study.run_tolerance_study(
        cant_p.build_basic, tolerances=(0.3, 0.15), results_root=str(tmp_path),
        task_name="study", device="cpu", nels=(8, 4, 2), max_iterations=12,
        dtype="float64")
    assert [r["tolerance"] for r in rows] == [0.3, 0.15]
    assert rows[0]["iterations"] <= rows[1]["iterations"]
    assert all(abs(r["volume_fraction"] - 0.4) < 1e-6 for r in rows)
    for name in ("study_30tol", "study_15tol"):
        assert (tmp_path / name / "optimization_summary.txt").exists()
    table = (tmp_path / "study_batch_summary.txt").read_text()
    assert "TOLERANCE STUDY SUMMARY" in table and table.count("\n") >= 7
