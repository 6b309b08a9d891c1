"""The program under test, as each kind of configuration drives it.

A system is built once from a cell (`build(cell, device)`), makes an
episode's start state from the seed (`prepare(seed, records)`), returns to
it (`restore()`), and runs one SIMP iteration (`one_step()` -> (energy as a
device scalar, CG iterations)); `fields()` gives the current (design,
displacements).  `spans(wrap)` puts the harness's spans around the
program's entries for a traced run.  The kind is the configuration's
`kind`, the module `systems/<kind>.py`.
"""

from __future__ import annotations

import importlib


def build(cell, device):
    module = importlib.import_module(f"simpbench.systems.{cell.config['kind']}")
    return module.System(cell, device)


def make_params(pt, config):
    """The port's OptimizationParameters from the configuration's `params`."""
    kw = dict(config["params"])
    if "mg_smooth_iters" in kw:
        kw["mg_smooth_iters"] = tuple(kw["mg_smooth_iters"])
    return pt.OptimizationParameters(**kw)
