"""The port's spans and counters (easysimp_tpu_torch/tracing.py) on the CPU:
the spans a traced step exports and how they nest, the counters against
what the code implies, bitwise-equal results with the profiler on and off,
no profiler range entered without a profiler, and the arithmetic that
reads spans and counters (simpbench/program_trace.py, the
`host_syncs_per_iteration` reader), with the harness's own trace reading
unchanged by the program's spans."""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from easysimp_tpu_torch import tracing
from easysimp_tpu_torch.ops import cuda_kernels as ck
from simpbench import cells, program_trace, systems
from simpbench import trace as harness

# tiny cells: the voxel one coarsened to three levels, so that level 1 has
# a stencil that the cycle applies
CELLS = {"voxel": ("cantilever128-cold", [8, 8, 8]),
         "tet": ("tet44-cold", [4, 4, 4])}
STEPS = {"voxel": 2, "tet": 1}     # voxel: a full setup, then a light one


@pytest.fixture
def system(request, monkeypatch):
    monkeypatch.setenv("EASYSIMP_MAX_COARSE_DOFS", "300")
    name, nels = CELLS[request.param]
    s = systems.build(cells.load_cell(name, overrides={"nels": nels}), "cpu")
    s.prepare(5, [])
    s.kind = request.param
    return s


def episode(s):
    """The cell's first STEPS iterations: (designs, displacements,
    energies, CG counts) after each."""
    s.restore()
    out = []
    for _ in range(STEPS[s.kind]):
        energy, cg = s.one_step()
        design, u = s.fields()
        out.append((design.clone(), u.clone(), energy.clone(), cg))
    return out


def traced(s, tmp_path):
    """An episode under a CPU-only profiler: (its output, the change of
    every counter, the program trace)."""
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = episode(s)
    after = tracing.counters()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    counts = {k: v - before.get(k, 0) for k, v in after.items()
              if v != before.get(k, 0)}
    return out, counts, program_trace.parse(path)


def chains(t):
    return {s.chain + (s.name,) for s in t.spans}


@pytest.mark.parametrize("system", ["voxel", "tet"], indirect=True)
def test_spans_nest_as_the_code_nests(system, tmp_path):
    _, _, t = traced(system, tmp_path)
    got = chains(t)
    want = {("cg",), ("cg", "cg.deflate"), ("cg", "sync.cg_norm"),
            ("cg", "sync.cg_exit"), ("cg", "cg.deflate", "sync.cg_deflate"),
            ("cg", "op.apply"), ("filter",), ("sens",), ("oc",),
            ("oc", "oc.pass"), ("oc", "oc.pass", "sync.oc_pass"),
            ("oc", "oc.pass", "sync.oc_lambdas"), ("oc", "sync.oc_lambda")}
    if system.kind == "voxel":
        want |= {("setup.full",), ("setup.light",), ("cg", "mg.vcycle"),
                 ("cg", "mg.vcycle", "mg.smooth.0", "op.apply"),
                 ("cg", "mg.vcycle", "mg.smooth.1", "mg.stencil.1"),
                 ("cg", "mg.vcycle", "mg.transfer.0"),
                 ("cg", "mg.vcycle", "mg.transfer.1"),
                 ("cg", "mg.vcycle", "mg.coarsest"),
                 ("setup.full", "mg.stencil.1")}
    else:
        want |= {("amg.setup",), ("cg", "amg.vcycle"),
                 ("cg", "amg.vcycle", "op.apply"),
                 ("amg.setup", "sync.amg_l1_inv"),
                 ("sync.block_jacobi_inv",)}
    assert want <= got, sorted(want - got)
    assert all(not n.startswith("sync.") for c in got for n in c[:-1])


@pytest.mark.parametrize("system", ["voxel", "tet"], indirect=True)
def test_counters_follow_the_code(system, tmp_path):
    out, counts, t = traced(system, tmp_path)
    cg = sum(o[3] for o in out)
    solves = STEPS[system.kind]
    assert counts["steps"] == solves
    assert counts["cg.iterations"] == cg
    # the norm is read before every pass and once more when it stops
    assert counts["sync.cg_norm"] == cg + solves
    assert counts["sync.cg_exit"] == counts["sync.cg_deflate"] == solves
    assert counts["sync.oc_pass"] == counts["sync.oc_lambdas"] \
        == len(t.named("oc.pass")) > 0
    assert counts["sync.oc_lambda"] == solves
    syncs = {k: v for k, v in counts.items() if k.startswith("sync.")}
    assert sum(syncs.values()) == sum(
        len(t.named(k)) for k in syncs)
    if system.kind == "voxel":
        # one V-cycle per CG pass and one before the loop
        assert len(t.named("mg.vcycle")) == cg + solves
        assert len(t.named("setup.full")) == len(t.named("setup.light")) == 1
    else:
        assert not t.named("mg.vcycle")
        assert len(t.named("amg.vcycle")) == cg + solves
        assert counts["sync.block_jacobi_inv"] == solves
        assert counts["sync.amg_l1_inv"] >= solves


@pytest.mark.parametrize("system", ["voxel", "tet"], indirect=True)
def test_profiler_changes_nothing(system, tmp_path):
    off = episode(system)
    on, _, t = traced(system, tmp_path)
    assert t.spans
    for (d0, u0, e0, c0), (d1, u1, e1, c1) in zip(off, on, strict=True):
        assert c0 == c1
        assert torch.equal(d0, d1) and torch.equal(u0, u1)
        assert torch.equal(e0, e1)


@pytest.mark.parametrize("system", ["voxel", "tet"], indirect=True)
def test_no_profiler_enters_no_record_function(system, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = tracing.counters().get("steps", 0)
    episode(system)
    assert tracing.counters()["steps"] == before + STEPS[system.kind]


def test_span_and_sync_without_a_profiler():
    assert tracing.span("cg") is tracing.span("oc")     # the shared no-op
    before = tracing.counters()
    with tracing.sync("probe"):
        pass
    got = tracing.host_read("probe", torch.arange(3))
    assert torch.equal(got, torch.arange(3))
    assert tracing.host_read("probe", torch.tensor(2.5)) == 2.5
    assert tracing.counters()["sync.probe"] == before.get("sync.probe", 0) + 3
    snap = tracing.counters()
    snap["sync.probe"] = -1                              # a copy
    assert tracing.counters()["sync.probe"] > 0


def test_kernel_launch_counters():
    """The kernels' launches live in the counter table, by storage dtype."""
    b32 = ck.launches("voxel_matvec", torch.float32)
    b16 = ck.launches("voxel_matvec", torch.bfloat16)
    both = ck.launches("voxel_matvec")
    tracing.count("launch.voxel_matvec.float32", 2)
    tracing.count("launch.voxel_matvec.bfloat16")
    assert ck.launches("voxel_matvec", torch.float32) == b32 + 2
    assert ck.launches("voxel_matvec", torch.bfloat16) == b16 + 1
    assert ck.launches("voxel_matvec") == both + 3
    assert not hasattr(ck.voxel_matvec, "launches")
    assert not hasattr(ck.voxel_energies, "launches_by_dtype")
    assert not hasattr(ck.voxel_matvec_simple_f32, "launches")


# --------------------------------------------------------------------------
# the arithmetic that reads spans and counters
# --------------------------------------------------------------------------

def _x(cat, name, ts, dur, **kw):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, **kw}


def _events(program=True):
    """Harness spans setup [0, 10] and step [10, 100]; program spans cg
    [12, 60] holding mg.vcycle [20, 40] holding mg.stencil.1 [22, 30], and
    op.apply [45, 50]; oc [70, 90] holding oc.pass [72, 80] holding
    sync.oc_pass [75, 79]; five kernels launched from five host ops."""
    ev = [_x("user_annotation", "simpbench:setup", 0, 10),
          _x("user_annotation", "simpbench:step", 10, 90)]
    if program:
        ev += [_x("user_annotation", "easysimp:" + n, a, b - a)
               for n, a, b in [("cg", 12, 60), ("mg.vcycle", 20, 40),
                               ("mg.stencil.1", 22, 30), ("op.apply", 45, 50),
                               ("oc", 70, 90), ("oc.pass", 72, 80),
                               ("sync.oc_pass", 75, 79)]]
    for k, (op, a, launch, start, dur) in enumerate(
            [("aten::mul", 1, 2, 5, 10), ("aten::add", 23, 24, 25, 10),
             ("aten::bmm", 46, 47, 50, 6), ("aten::sum", 73, 73.5, 74, 2),
             ("aten::fill_", 95, 95.5, 96, 2)]):
        ev += [_x("cpu_op", op, a, 3),
               _x("cuda_runtime", "cudaLaunchKernel", launch, 0.2,
                  args={"correlation": k + 1}),
               {"cat": "kernel", "name": f"kernel{k}", "ts": start,
                "dur": dur, "args": {"correlation": k + 1}}]
    return ev


def _trace_file(tmp_path, program=True):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events(program)}))
    return path


def test_program_trace_arithmetic(tmp_path):
    t = program_trace.parse(_trace_file(tmp_path))
    assert [(op.span, chain, op.launched_by)
            for op, chain in zip(t.ops, t.chains)] == [
        ("setup", (), "aten::mul"),
        ("step", ("cg", "mg.vcycle", "mg.stencil.1"), "aten::add"),
        ("step", ("cg", "op.apply"), "aten::bmm"),
        ("step", ("oc", "oc.pass"), "aten::sum"),
        ("step", (), "aten::fill_")]
    assert t.named_ops().gaps() == [("step/mg.stencil.1/aten::add", 10.0),
                                    ("step/op.apply/aten::bmm", 15.0),
                                    ("step/oc.pass/aten::sum", 18.0),
                                    ("step/aten::fill_", 20.0)]
    assert [n for n, _ in t.named_ops(host_op=False).gaps()] == [
        "step/mg.stencil.1", "step/op.apply", "step/oc.pass", "step"]
    assert program_trace.breakdown(t)["idle_gaps"][0] == [
        "step/aten::fill_", 2e-5]
    assert t.busy_us(12, 60) == 19.0 and t.busy_us(0, 100) == 30.0
    assert t.busy_us(26, 52) == 11.0 and t.busy_us(60, 70) == 0.0
    assert program_trace.launches_per_cg_iteration(t, 2) == 1.0
    assert math.isclose(program_trace.cg_idle_pct(t), 100 * 29 / 48)
    assert math.isclose(program_trace.oc_ms(t, 2), 0.01)
    assert math.isclose(program_trace.named_idle_share(t), 100 * 43 / 63)
    voxel = cells.load_cell("cantilever128-cold").config
    one = program_trace.stencil_apply_seconds((128,) * 3, 1, "bfloat16",
                                              "bfloat16")
    assert math.isclose(program_trace.stencil_apply_roofline(t, voxel),
                        100 * one / 10e-6)
    tet = cells.load_cell("tet44-cold").config
    one = program_trace.unstructured_apply_seconds(511_104, 273_375)
    assert math.isclose(program_trace.element_apply_roofline(t, tet),
                        100 * one / 6e-6)
    bare = program_trace.parse(_trace_file(tmp_path, program=False))
    assert bare.chains == [()] * 5 and not bare.spans
    assert program_trace.cg_idle_pct(bare) is None
    assert program_trace.stencil_apply_roofline(bare, voxel) is None


def test_apply_bounds():
    """Level 1 of the 128^3 bfloat16 cycle: 274,625 nodes of 243 bfloat16
    coefficients (133.5 MB) and three 3-value fields; the 44^3 x 6-tet
    apply: 0.104 ms."""
    b = program_trace.stencil_apply_bytes((128,) * 3, 1, "bfloat16",
                                          "bfloat16")
    assert b == 65 ** 3 * (243 * 2 + 9 * 2)
    s = program_trace.stencil_apply_seconds((128,) * 3, 1, "bfloat16",
                                            "bfloat16")
    assert round(s * 1e3, 4) == 0.0413
    u = program_trace.unstructured_apply_seconds(511_104, 273_375)
    assert round(u * 1e3, 4) == 0.1041


@pytest.mark.parametrize("program", [False, True])
def test_harness_trace_reads_the_same(program, tmp_path):
    """simpbench/trace.py reads the same from a trace with the program's
    spans as from one without: spans, host ops, busy time, breakdown."""
    t = harness.parse_chrome_trace(_trace_file(tmp_path, program))
    assert [(op.span, op.launched_by) for op in t.ops] == [
        ("setup", "aten::mul"), ("step", "aten::add"), ("step", "aten::bmm"),
        ("step", "aten::sum"), ("step", "aten::fill_")]
    assert t.busy_us() == 30.0
    b = harness.breakdown(t)
    assert b["device_ops"][0] == ["kernel0", 1e-5]
    assert b["idle_gaps"][0] == ["step/aten::fill_", 2e-5]


@pytest.mark.parametrize("counts,want", [
    ({"steps": 4, "sync.cg_norm": 30, "sync.oc_pass": 10, "cg.iterations": 26},
     10.0),
    ({"sync.cg_norm": 3}, None)])
def test_host_syncs_reader(counts, want, monkeypatch):
    monkeypatch.setattr(tracing, "_counts", dict(counts))
    got = cells.reader("host_syncs_per_iteration.tet").read(None)
    assert got == want
