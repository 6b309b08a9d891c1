"""Where a voxel cell's allocated device memory peaks, and what is alive
there.

    python3 scripts/voxel_memory_peak.py --workload cantilever128-cold \
        --seed 1 [--episodes 2]

run from the root of a checkout on a CUDA card (the checkout's own
`simpbench` and `easysimp_tpu_torch` are imported).  The cell's system is
built and prepared as `simpbench/run.py` does, then runs `--episodes`
whole episodes (the first is the harness's warm-up).  It prints
`max_memory_allocated` over set-up and over each episode, and records one
episode (`--record`, the last by default) with
`torch.cuda.memory._record_memory_history`: the allocator's trace is
replayed to find the moment of the episode's largest allocated total, and
it prints the allocation that reached it (the innermost frames in the
program or the harness) and the bytes allocated in the episode and alive
there, grouped by where each was allocated.  The last line is one JSON
object of the numbers, `max_memory_reserved` included.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

OURS = ("easysimp_tpu_torch", "simpbench")


def where(frames, depth=3):
    """The innermost `depth` frames of the program or the harness, as
    "file:line function" joined by " < "."""
    ours = [f for f in frames if any(k in f["filename"] for k in OURS)]
    return " < ".join(f"{f['filename'].split('/')[-1]}:{f['line']} "
                      f"{f['name']}" for f in ours[:depth]) or "(outside)"


def replay(events):
    """(peak bytes, index of the event that reached it) of the total that
    the recorded allocations and frees add to what was alive before."""
    total = peak = 0
    at = None
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            total += e["size"]
        elif e["action"] == "free_completed":
            total -= e["size"]
        if total > peak:
            peak, at = total, i
    return peak, at


def alive_at(events, at):
    """{address: event} of the blocks allocated and not freed at index
    `at`."""
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    return live


def report(label, events, peak, at, top=14):
    live = alive_at(events, at)
    groups = collections.Counter()
    for e in live.values():
        groups[where(e["frames"], 2)] += e["size"]
    print(f"[{label}] peak +{peak / 1e9:.4f} GB at event {at} of "
          f"{len(events)}, reached by {events[at]['size'] / 1e6:.1f} MB "
          f"from {where(events[at]['frames'], 6)}")
    for w, n in groups.most_common(top):
        print(f"[{label}]   {n / 1e6:9.1f} MB  {w}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--record", type=int, default=-1,
                    help="the episode recorded, -1 the last")
    args = ap.parse_args(argv)
    from simpbench import cells, systems

    record = args.record % args.episodes
    cell = cells.load_cell(args.workload)
    system = systems.build(cell, torch.device("cuda"))
    system.prepare(args.seed, [])
    torch.cuda.synchronize()
    phases = {"build and prepare": torch.cuda.max_memory_allocated()}
    events, base = None, 0
    for ep in range(args.episodes):
        torch.cuda.reset_peak_memory_stats()
        if ep == record:
            base = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(
                enabled="all", context="alloc", stacks="python",
                max_entries=3_000_000)
        system.restore()
        for _ in range(cell.traffic["episode_iterations"]):
            system.one_step()
        torch.cuda.synchronize()
        phases[f"episode {ep}"] = torch.cuda.max_memory_allocated()
        if ep == record:
            events = torch.cuda.memory._snapshot()["device_traces"][0]
            torch.cuda.memory._record_memory_history(enabled=None)
    for name, n in phases.items():
        print(f"max_memory_allocated over {name}: {n / 1e9:.4f} GB")
    peak, at = replay(events)
    print(f"allocated as episode {record} starts: {base / 1e9:.4f} GB")
    report(f"episode {record}", events, peak, at)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(),
           "peak_by_phase": phases, "recorded_episode": record,
           "recorded_base": base, "recorded_peak": base + peak,
           "max_memory_reserved": torch.cuda.max_memory_reserved()}
    print(f"max_memory_reserved {out['max_memory_reserved'] / 1e9:.4f} GB")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
