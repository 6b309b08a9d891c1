"""The traced run's arithmetic, from `torch.profiler`'s chrome trace.

Each device operation (kernel, copy, fill) is tied to its launch by
correlation id, and so to the harness span the host was in when it
launched it.  The device's busy time is the union of the operations'
intervals; an idle gap lies between two of them and is named by the span
and the host operation that launched the next one.  (The arithmetic of
`chip_smoke.py`'s trace of the main path, without its patching of the
program.)
"""

from __future__ import annotations

import bisect
import collections
import json
from dataclasses import dataclass, field

SPAN_PREFIX = "simpbench:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceOp:
    name: str
    start: float          # microseconds, the trace's clock
    dur: float
    span: str             # harness span at its launch, or ""
    launched_by: str      # host operation around its launch, or ""


@dataclass
class Trace:
    ops: list = field(default_factory=list)       # DeviceOp, by start

    def busy_us(self):
        """Union of the device operations' intervals."""
        busy, end = 0.0, -float("inf")
        for op in self.ops:
            b = op.start + op.dur
            if b > end:
                busy += b - max(op.start, end)
                end = b
        return busy

    def gaps(self):
        """(name, microseconds) of every idle gap between two device
        operations, named by what launched the second."""
        out, end = [], None
        for op in self.ops:
            if end is not None and op.start > end:
                name = op.span or "outside spans"
                if op.launched_by:
                    name += "/" + op.launched_by
                out.append((name, op.start - end))
            b = op.start + op.dur
            end = b if end is None else max(end, b)
        return out

    def by_name(self):
        t = collections.Counter()
        for op in self.ops:
            t[op.name] += op.dur
        return t


def _innermost(intervals, starts, ts):
    """The innermost (latest-starting) interval of a sorted list that holds
    ts, looking back at most 64 intervals."""
    i = bisect.bisect_right(starts, ts) - 1
    for j in range(i, max(i - 64, -1), -1):
        a, b, name = intervals[j]
        if a <= ts <= b:
            return name
    return ""


def parse_chrome_trace(path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, spans, cpu_ops, device = {}, {}, {}, []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = (e["ts"], e.get("tid"))
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0),
                 e["name"][len(SPAN_PREFIX):]))
        elif cat == "cpu_op":
            cpu_ops.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif cat in DEVICE_CATS:
            device.append(e)
    index = {}
    for table in (spans, cpu_ops):
        for tid, rows in table.items():
            rows.sort()
            index[id(rows)] = [r[0] for r in rows]
    trace = Trace()
    for e in device:
        ts, tid = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        span = by = ""
        if ts is not None:
            if tid in spans:
                span = _innermost(spans[tid], index[id(spans[tid])], ts)
            if tid in cpu_ops:
                by = _innermost(cpu_ops[tid], index[id(cpu_ops[tid])], ts)
        trace.ops.append(DeviceOp(e["name"], float(e["ts"]),
                                  float(e.get("dur", 0)), span, by))
    trace.ops.sort(key=lambda op: op.start)
    return trace


def breakdown(trace, top=10):
    """The traced run's `breakdown`: the device operations that took most
    time, and the idle gaps by what the host launched after them (totals in
    seconds)."""
    gaps = collections.Counter()
    for name, us in trace.gaps():
        gaps[name] += us
    return {
        "device_ops": [[n[:160], t / 1e6]
                       for n, t in trace.by_name().most_common(top)],
        "idle_gaps": [[n[:160], t / 1e6] for n, t in gaps.most_common(top)],
    }
