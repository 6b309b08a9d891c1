"""One run of one cell of the benchmark of the PyTorch/CUDA port.

    python3 simpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  The
traffic is closed-loop episodes of fixed work, one optimisation at a time:
set-up builds the program's SIMP iteration once, makes the episode's start
state from the seed and runs one episode to warm every shape up; the window
then repeats whole episodes, each from that start state, until the first
episode boundary after --seconds.  No synchronisation is added inside an
episode: iteration times come from CUDA events read after the window.

With --trace 0 the last line of stdout carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from `torch.profiler`
over a few whole episodes inside the window (the rest untraced).  Either
way one episode drawn from the seed is copied to the host as it runs, and
after the window, with the program's state freed, the plain reference
judges it (`check.py`): `correct`, and each number beside its limit under
`checks`, last in the line and last on stderr.

Exits 2 without a usable card, 3 without the program, 4 when a module of
JAX or of the JAX package was loaded, printing no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Build and kernel caches at fixed paths inside the checkout; the program's
# own CUDA build goes to easysimp_tpu_torch/_build/.  The program's bench
# knobs (BENCH_*) stay at their defaults: the configuration sets the rest.
_CACHE = ROOT / ".simpbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["USE_FLAX"] = "0"
for _k in [k for k in os.environ if k.startswith("BENCH_")
           and k != "BENCH_RUN"]:
    del os.environ[_k]

import torch  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "easysimp_tpu"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not load, each
    name compared whole (easysimp_tpu_torch is not easysimp_tpu)."""
    return sorted({name.split(".")[0] for name, mod in sys.modules.items()
                   if mod is not None} & FORBIDDEN)


@dataclass
class Run:
    """What the metrics' readers read (metrics/<name>.py `read(run)`)."""

    cell: object
    setup_s: float = math.nan
    window_s: float = math.nan
    iterations: int = 0
    iteration_ms: list = field(default_factory=list)
    cg: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: object = None             # trace.Trace of the traced episodes
    trace_window_s: float = math.nan
    traced_iterations: int = 0


class Clock:
    """Marks on the device's stream (CUDA events), or the host clock on
    the CPU; read after the window."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Capture:
    """Host copies of one episode's designs and displacements, made on the
    stream as the episode runs (pinned buffers, no synchronisation)."""

    def __init__(self, design, u, n):
        pin = design.is_cuda
        self.x = torch.empty((n + 1, *design.shape), dtype=design.dtype,
                             pin_memory=pin)
        self.u = torch.empty((n, *u.shape), dtype=u.dtype, pin_memory=pin)
        self.energy, self.cg = [], []

    def start(self, design):
        self.x[0].copy_(design, non_blocking=True)

    def step(self, k, design, u, energy, cg):
        self.u[k].copy_(u, non_blocking=True)
        self.x[k + 1].copy_(design, non_blocking=True)
        self.energy.append(energy)
        self.cg.append(cg)

    def records(self):
        return [dict(level=0, x_in=self.x[k], u=self.u[k],
                     energy=float(self.energy[k]), x_out=self.x[k + 1],
                     cg=self.cg[k]) for k in range(len(self.energy))]


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None):
    """One run; returns (result dict, stderr lines of the checks) or an
    exit code."""
    from simpbench import cells, check, systems
    from simpbench import trace as tracing

    device = torch.device(device)
    cell = cells.load_cell(workload, overrides=overrides)
    if device.type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        log(f"needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    try:
        import easysimp_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program easysimp_tpu_torch is missing: {e}")
        return 3

    traffic = cell.traffic
    n_iter = traffic["episode_iterations"]
    system = systems.build(cell, device)
    records = []
    system.prepare(seed, records)
    system.restore()                          # warm-up: one whole episode
    for _ in range(n_iter):
        system.one_step()
    sync(device)

    pick = cells.rng(seed, cells.SEED_CAPTURE)
    captured = int(pick.integers(0, 2))       # episode 0 or 1 of the window
    first_traced = 2
    n_traced = traffic["traced_episodes"] if trace else 0
    capture = Capture(*system.fields(), n_iter)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        def wrap(name, fn):
            def spanned(*a, **kw):
                with record_function(tracing.SPAN_PREFIX + name):
                    return fn(*a, **kw)
            return spanned

        system.spans(wrap)
        restore = wrap("restore", system.restore)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    else:
        restore = system.restore

    clock = Clock(device)
    run = Run(cell)
    energies, episodes = [], []
    sync(device)
    # set-up's objects leave the collector's generations, so that a full
    # collection inside the window does not walk every module loaded
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    run.setup_s = t_start - T0
    ep = 0
    while True:
        if trace and ep == first_traced:
            sync(device)
            prof.__enter__()
            tw0 = time.perf_counter()
        restore()
        marks = []
        for k in range(n_iter):
            marks.append(clock.mark())
            if ep == captured and k == 0:
                capture.start(system.fields()[0])
            energy, cg = system.one_step()
            energies.append(energy)
            run.cg.append(cg)
            if ep == captured:
                capture.step(k, *system.fields(), energy, cg)
        marks.append(clock.mark())
        episodes.append(marks)
        ep += 1
        if trace and ep == first_traced + n_traced:
            sync(device)
            run.trace_window_s = time.perf_counter() - tw0
            prof.__exit__(None, None, None)
            run.traced_iterations = n_traced * n_iter
        if (time.perf_counter() - t_start >= seconds and ep > captured
                and ep >= (first_traced + n_traced if trace else 0)):
            break
    sync(device)
    run.window_s = time.perf_counter() - t_start
    gc.unfreeze()
    run.iterations = ep * n_iter
    run.iteration_ms = [clock.ms(m[k], m[k + 1])
                        for m in episodes for k in range(n_iter)]
    episode_ms = sorted(sum(run.iteration_ms[i:i + n_iter])
                        for i in range(0, len(run.iteration_ms), n_iter))
    log(f"window {run.window_s:.3f} s, {ep} episodes; ms per episode: "
        f"min {episode_ms[0]:.1f} median "
        f"{episode_ms[len(episode_ms) // 2]:.1f} max {episode_ms[-1]:.1f}; "
        f"iteration p95 "
        f"{cells.reader('iteration_p95_ms').read(run):.3f} ms")
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips,
               "memory_peak_bytes": run.memory_peak_bytes}
    else:
        import resource

        run.memory_peak_bytes = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": run.memory_peak_bytes}
    energy_host = torch.stack([torch.as_tensor(e).reshape(())
                               for e in energies]).double().cpu()
    failed = int(sum(1 for e, c in zip(energy_host.tolist(), run.cg)
                     if not math.isfinite(e)
                     or c >= cell.config["params"]["cg_maxiter"]))

    breakdown = None
    if trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            run.trace = tracing.parse_chrome_trace(path)
        finally:
            os.unlink(path)
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace_window_s
        breakdown = tracing.breakdown(run.trace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.metrics):
        value = cells.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs on the card
    records += capture.records()
    del system, capture, prof, energies
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.checks(cell, check.measure(cell, records, device))
    result = {"correct": check.is_correct(checks),
              "attempted": run.iterations, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines


def main(argv=None, overrides=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda; cpu rehearses a run at a tiny size")
    args = parser.parse_args(argv)
    stdout = sys.stdout
    # the program's progress lines go to stderr: stdout carries the result
    sys.stdout = sys.stderr
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), args.device, overrides)
    finally:
        sys.stdout = stdout
    if isinstance(out, int):
        return out
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    result, lines = out
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
