"""The port's Abaqus .inp -> VTU converter
(easysimp_tpu_torch/scripts/inp_to_vtu.py): the three tests of
tests/test_inp_converter.py on it, and the file it writes byte for byte
equal to the one the JAX package's scripts/inp_to_vtu.py writes."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from easysimp_tpu_torch.post.vtu import read_vtu
from easysimp_tpu_torch.scripts.inp_to_vtu import convert_inp_to_vtu, \
    parse_inp
from test_inp_converter import INP_SAMPLE, QUADRATIC_INP

ROOT = Path(__file__).resolve().parents[1]


def _reference_converter():
    spec = importlib.util.spec_from_file_location(
        "inp_to_vtu_reference", ROOT / "scripts" / "inp_to_vtu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_parse_and_convert(tmp_path):
    inp = tmp_path / "model.inp"
    inp.write_text(INP_SAMPLE)

    points, blocks, elsets = parse_inp(str(inp))
    assert points.shape == (10, 3)
    assert [b["abq"] for b in blocks] == ["C3D8", "C3D4", "T3D2"]
    assert elsets["tets"] == {2, 3}
    assert elsets["range_set"] == {1, 2, 3}
    assert elsets["solid"] == {1}
    assert elsets["rods"] == {4}
    # 0-based connectivity
    np.testing.assert_array_equal(blocks[0]["conn"][0],
                                  [0, 1, 2, 3, 4, 5, 6, 7])

    out = convert_inp_to_vtu(str(inp))
    data = read_vtu(out)
    assert data.points.shape == (10, 3)
    assert list(data.types) == [12, 10, 10, 3]
    np.testing.assert_array_equal(data.offsets, [8, 12, 16, 18])
    assert "elset_id" in data.cell_data
    assert "element_id" in data.cell_data


def test_continuation_lines(tmp_path):
    inp = tmp_path / "cont.inp"
    inp.write_text(
        "*NODE\n"
        + "\n".join(f"{i}, {float(i)}, 0, 0" for i in range(1, 21))
        + "\n*ELEMENT, TYPE=C3D20\n"
        + "1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,\n"
        + "11, 12, 13, 14, 15, 16, 17, 18, 19, 20\n"
    )
    points, blocks, _ = parse_inp(str(inp))
    assert blocks[0]["conn"].shape == (1, 20)
    assert blocks[0]["vtk_type"] == 25


def test_quadratic_element_catalogue(tmp_path):
    """C3D15/S6/S8/T3D3 map to VTK 26/22/23/21 (InpToVtu.jl:43-55)."""
    inp = tmp_path / "quad.inp"
    inp.write_text(QUADRATIC_INP)
    points, blocks, _ = parse_inp(str(inp))
    assert [(b["abq"], b["vtk_type"], b["nn"]) for b in blocks] == [
        ("C3D15", 26, 15), ("S6", 22, 6), ("S8R", 23, 8), ("T3D3", 21, 3)]

    out = convert_inp_to_vtu(str(inp))
    data = read_vtu(out)
    assert list(data.types) == [26, 22, 23, 21]
    np.testing.assert_array_equal(data.offsets, [15, 21, 29, 32])
    # Abaqus ordering passes through 1:1 (0-based)
    np.testing.assert_array_equal(data.connectivity[:15], np.arange(15))


def test_output_byte_equal_to_reference(tmp_path):
    """From the same .inp files, the VTU and the elset sidecar are the JAX
    script's bytes; the command line writes them too, importing no jax."""
    reference = _reference_converter()
    for name, text in (("model", INP_SAMPLE), ("quad", QUADRATIC_INP)):
        inp = tmp_path / f"{name}.inp"
        inp.write_text(text)
        want = reference.convert_inp_to_vtu(str(inp),
                                            str(tmp_path / f"{name}_r.vtu"))
        got = convert_inp_to_vtu(str(inp), str(tmp_path / f"{name}_p.vtu"))
        assert Path(got).read_bytes() == Path(want).read_bytes()
        sidecars = [Path(p + ".elsets.txt") for p in (want, got)]
        assert sidecars[0].exists() == sidecars[1].exists()
        if sidecars[0].exists():
            assert sidecars[0].read_text() == sidecars[1].read_text()

    out = tmp_path / "model_cli.vtu"
    check = ("import runpy, sys; sys.argv = ['inp_to_vtu', sys.argv[1], "
             "sys.argv[2]]; runpy.run_module("
             "'easysimp_tpu_torch.scripts.inp_to_vtu', run_name='__main__'); "
             "assert not any(m.split('.')[0] in ('jax', 'easysimp_tpu') "
             "for m in sys.modules), 'jax imported'")
    subprocess.run([sys.executable, "-c", check, str(tmp_path / "model.inp"),
                    str(out)], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.read_bytes() == (tmp_path / "model_r.vtu").read_bytes()
