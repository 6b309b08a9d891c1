"""The program's own spans in a traced run, and the metrics they give.

`trace.py` ties each device operation to the harness span and the host
operation around its launch.  The program (`easysimp_tpu_torch.tracing`)
puts spans of its own, named `easysimp:<name>`, where the work happens: CG,
the V-cycle by level, the stencil apply, OC, each host sync.  `parse` reads
a chrome trace through `trace.py` and adds to each device operation the
chain of program spans around its launch (outermost first), and to each
program span its interval and the chain around it.  From that:

  launches_per_cg_iteration  device operations launched inside `cg` spans
                             over the CG iterations (counter
                             `cg.iterations` over the traced episodes);
  cg_idle_pct                share of the `cg` spans' wall in which no
                             device operation runs;
  oc_ms                      host milliseconds inside `oc` spans per SIMP
                             iteration;
  stencil_apply_roofline     the least time of every `mg.stencil.<l>` apply
                             inside a V-cycle (`stencil_apply_seconds`)
                             over the device time of the operations
                             launched inside them;
  element_apply_roofline     the same for every `op.apply` of the
                             unstructured operator
                             (`unstructured_apply_seconds`);
  named_idle_share           share of the `step` span's idle time whose
                             gap a program span names;

and `breakdown` names an idle gap `<harness span>/<innermost program
span>/<host operation>`.  Nothing here runs the program: the caller
profiles the episodes, keeps the chrome trace and the counters' change over
them, and passes both.  `run.py` keeps neither yet, so `BENCHMARK.json`
reads none of these (PERF.md, open questions).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
import json
import math
from dataclasses import dataclass

from simpbench import trace as harness
from simpbench.roofline import HBM_BYTES_PER_S

PROGRAM_PREFIX = "easysimp:"
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


# --------------------------------------------------------------------------
# the least time of a stencil apply and of an unstructured apply
# --------------------------------------------------------------------------

def stencil_apply_bytes(nels, level, stencil_dtype, field_dtype):
    """Bytes of one masked stencil apply at multigrid level `level` of an
    `nels` grid, each read once and the output written once: the 27 3x3
    blocks of coefficients (243 values) per level node in the stencil's
    storage dtype, and the input field, the mask and the output field, 3
    values per node each, in the cycle's dtype."""
    nodes = math.prod((n >> level) + 1 for n in nels)
    return nodes * (243 * ITEMSIZE[stencil_dtype]
                    + 3 * 3 * ITEMSIZE[field_dtype])


def stencil_apply_seconds(nels, level, stencil_dtype, field_dtype):
    """Bytes at the card's bandwidth: 27 multiply-adds of a 3x3 block per
    node are ~0.5 flop per byte, far under the card's balance."""
    return stencil_apply_bytes(nels, level, stencil_dtype,
                               field_dtype) / HBM_BYTES_PER_S


def unstructured_apply_bytes(n_elements, n_dofs, nodes_per_element=4,
                             dtype="float32"):
    """Bytes of one masked apply of the unstructured operator: the stored
    d x d element matrices (d = 3 nodes_per_element), the element scale,
    the int64 dof map (d per element), and the displacement field read,
    the mask read and the output written (n_dofs values each)."""
    d, s = 3 * nodes_per_element, ITEMSIZE[dtype]
    return n_elements * (d * d * s + s + 8 * d) + 3 * n_dofs * s


def unstructured_apply_seconds(n_elements, n_dofs, nodes_per_element=4,
                               dtype="float32"):
    """Bytes at the card's bandwidth (a gemv per element: 2 flops per 4
    bytes of its matrix)."""
    return unstructured_apply_bytes(n_elements, n_dofs, nodes_per_element,
                                    dtype) / HBM_BYTES_PER_S


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

@dataclass
class Span:
    name: str
    start: float
    end: float
    chain: tuple = ()       # the program spans around it, outermost first


@dataclass
class ProgramTrace:
    ops: list               # trace.DeviceOp, by start (trace.py's reading)
    chains: list            # of each op, the program spans at its launch
    spans: list             # program Span, by start

    def named(self, name):
        """The spans `name` that no span of that name holds."""
        return [s for s in self.spans
                if s.name == name and name not in s.chain]

    def busy_us(self, a, b):
        """Time in [a, b] in which some device operation runs."""
        lo = bisect.bisect_left(self._end_max, a)
        hi = bisect.bisect_left(self._starts, b)
        clipped = [dataclasses.replace(op, start=max(op.start, a),
                                       dur=min(op.start + op.dur, b)
                                       - max(op.start, a))
                   for op in self.ops[lo:hi]]
        return harness.Trace([op for op in clipped if op.dur > 0]).busy_us()

    @functools.cached_property
    def _starts(self):
        return [op.start for op in self.ops]

    @functools.cached_property
    def _end_max(self):
        """The running maximum of the ops' ends: sorted, for bisect."""
        return list(itertools.accumulate((op.start + op.dur
                                          for op in self.ops), max))

    def named_ops(self, host_op=True):
        """`trace.Trace` of the ops with the innermost program span joined
        to the harness span, so that its gaps read `<harness span>/<program
        span>/<host operation>` (without the host operation unless
        `host_op`)."""
        return harness.Trace([
            dataclasses.replace(
                op, launched_by=op.launched_by if host_op else "",
                span="/".join(p for p in (op.span or "outside spans",
                                          chain[-1] if chain else "") if p))
            for op, chain in zip(self.ops, self.chains)])


def _nest(intervals, points):
    """Chains of properly nested intervals [(start, end, name)] of one host
    thread: for each point of `points` the names of the intervals that hold
    it, outermost first; and each interval with those around it."""
    intervals = sorted(intervals, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    at, around, stack, i = [()] * len(points), [], [], 0

    def push(upto):
        nonlocal i
        while i < len(intervals) and intervals[i][0] <= upto:
            a, b, name = intervals[i]
            while stack and stack[-1][1] < a:
                stack.pop()
            around.append(Span(name, a, b, tuple(s[2] for s in stack)))
            stack.append(intervals[i])
            i += 1

    for j in order:
        push(points[j])
        while stack and stack[-1][1] < points[j]:
            stack.pop()
        at[j] = tuple(s[2] for s in stack)
    push(math.inf)
    return at, around


def parse(path) -> ProgramTrace:
    """The program trace of a chrome trace file: `trace.py`'s device
    operations, each with its chain of program spans."""
    ops = harness.parse_chrome_trace(path).ops
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, spans, device = {}, {}, []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = (e["ts"], e.get("tid"))
        elif cat == "user_annotation" and e["name"].startswith(
                PROGRAM_PREFIX):
            spans.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0),
                 e["name"][len(PROGRAM_PREFIX):]))
        elif cat in harness.DEVICE_CATS:
            device.append(e)
    # the device events in trace.py's order: as listed, stably by start
    device.sort(key=lambda e: float(e["ts"]))
    launches = {}
    for k, e in enumerate(device):
        ts, tid = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        if ts is not None:
            launches.setdefault(tid, []).append((k, ts))
    chains, program = [()] * len(device), []
    for tid in spans.keys() | launches.keys():
        rows = launches.get(tid, [])
        at, around = _nest(spans.get(tid, []), [ts for _, ts in rows])
        for (k, _), chain in zip(rows, at):
            chains[k] = chain
        program += around
    if [(op.name, op.start) for op in ops] != [
            (e["name"], float(e["ts"])) for e in device]:
        raise ValueError("trace.py read the device operations otherwise")
    return ProgramTrace(ops, chains, sorted(program, key=lambda s: s.start))


# --------------------------------------------------------------------------
# the metrics
# --------------------------------------------------------------------------

def _level(name, prefix):
    return int(name[len(prefix):]) if name.startswith(prefix) else None


def launches_per_cg_iteration(t, cg_iterations):
    n = sum(1 for chain in t.chains if "cg" in chain)
    return n / cg_iterations if cg_iterations else None


def cg_idle_pct(t):
    cg = t.named("cg")
    wall = sum(s.end - s.start for s in cg)
    if not wall:
        return None
    busy = sum(t.busy_us(s.start, s.end) for s in cg)
    return 100.0 * (1.0 - busy / wall)


def oc_ms(t, iterations):
    oc = t.named("oc")
    if not oc or not iterations:
        return None
    return sum(s.end - s.start for s in oc) / 1e3 / iterations


def cycle_dtypes(config):
    """(stencil storage dtype, field dtype) of the configuration's
    V-cycle."""
    p = config["params"]
    cycle = p.get("mg_cycle_dtype") or p["dtype"]
    return p.get("mg_stencil_dtype") or cycle, cycle


def stencil_apply_roofline(t, config):
    stencil_dtype, field_dtype = cycle_dtypes(config)
    bound = sum(stencil_apply_seconds(config["nels"], lvl, stencil_dtype,
                                      field_dtype)
                for s in t.spans if "mg.vcycle" in s.chain
                and (lvl := _level(s.name, "mg.stencil.")) is not None)
    spent = sum(op.dur for op, chain in zip(t.ops, t.chains)
                if "mg.vcycle" in chain and any(
                    _level(n, "mg.stencil.") is not None
                    for n in chain)) / 1e6
    return 100.0 * bound / spent if spent else None


def element_apply_roofline(t, config):
    nels = config["nels"]
    one = unstructured_apply_seconds(6 * math.prod(nels),
                                     3 * math.prod(n + 1 for n in nels), 4,
                                     config["params"]["dtype"])
    spent = sum(op.dur for op, chain in zip(t.ops, t.chains)
                if "op.apply" in chain) / 1e6
    return 100.0 * len(t.named("op.apply")) * one / spent if spent else None


def named_idle_share(t, harness_span="step"):
    """Share of the idle time inside the harness span `harness_span` whose
    gap is named by a program span."""
    total = named = 0.0
    for name, us in t.named_ops(host_op=False).gaps():
        if name == harness_span or name.startswith(harness_span + "/"):
            total += us
            named += us if name != harness_span else 0.0
    return 100.0 * named / total if total else None


def breakdown(t, top=10):
    """`trace.breakdown` with the idle gaps named by program spans."""
    return harness.breakdown(t.named_ops(), top)
