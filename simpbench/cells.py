"""A cell's files, found by name, and the inputs it makes from the seed.

`BENCHMARK.json` names each cell (`workloads`), its configuration and its
traffic mix.  The cell's own limits are in `workloads/<cell>.json`, the
traffic mix in `traffic/<traffic>.json`, the configuration in the `file`
that `BENCHMARK.json` gives, and each metric's reader in
`metrics/<metric>.py`.  Adding a cell, a configuration or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import copy
import importlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    metrics: list        # BENCHMARK.json metric entries this cell reports
    per_layer: list

    def grid(self, level=0):
        """The cell's voxel counts per axis at continuation level `level`
        (each level halves them)."""
        return tuple(int(n) >> level for n in self.config["nels"])


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT, overrides=None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files.  `overrides` (a
    dict merged into the configuration) serves the tests' tiny sizes."""
    bench = benchmark(root)
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = copy.deepcopy(load_json(Path(root) / entry["file"]))
    config.update(overrides or {})
    return Cell(
        name=name, config=config,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "workloads" / f"{name}.json")["limits"],
        chips=int(w["chips"]),
        metrics=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric_name):
    """The module that reads one metric: metrics/<name>.py, `read(run)`.
    A metric split by the cells that report it, `<name>.<part>`, is read
    by the same module as `<name>`."""
    return importlib.import_module(
        f"simpbench.metrics.{metric_name.split('.')[0]}")


def rng(seed, stream):
    """A numpy Generator for one use of the seed; any whole number works."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


SEED_DESIGN, SEED_SAMPLE, SEED_CAPTURE = 1, 2, 3


def start_design(config, seed, shape):
    """The start design: the uniform volume fraction plus a seeded field
    uniform in [-amplitude, amplitude] with its mean removed, so the mean
    stays the volume fraction (float64)."""
    p = config["seed_perturbation"]
    noise = rng(seed, SEED_DESIGN).uniform(-1.0, 1.0, size=shape)
    noise -= noise.mean()
    return config["params"]["volume_fraction"] + p["amplitude"] * noise
