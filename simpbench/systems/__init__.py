"""The program under test, as each kind of configuration drives it.

A system is built once from a cell (`build(cell, device)`), makes an
episode's start state from the seed (`prepare(seed, records)`), returns to
it (`restore()`), and runs one SIMP iteration (`one_step()` -> (energy as a
device scalar, CG iterations)); `fields()` gives the current (design,
displacements).  `spans(wrap)` puts the harness's spans around the
program's entries for a traced run.  The kind is the configuration's
`kind`, the module `systems/<kind>.py`, which also gives the port's grid
of the kind (`port_grid(pt, nels)`).  The supports and the load come from
the configuration through `boundary`.
"""

from __future__ import annotations

import importlib

import numpy as np

from ..cells import in_grid


def build(cell, device):
    module = importlib.import_module(f"simpbench.systems.{cell.config['kind']}")
    return module.System(cell, device)


def make_params(pt, config):
    """The port's OptimizationParameters from the configuration's `params`."""
    kw = dict(config["params"])
    if "mg_smooth_iters" in kw:
        kw["mg_smooth_iters"] = tuple(kw["mg_smooth_iters"])
    return pt.OptimizationParameters(**kw)


def _nodes(pt, grid, selection):
    kind = selection["select"]
    if kind == "plane":
        ids = pt.select_nodes_by_plane(grid, selection["point"],
                                       selection["normal"],
                                       selection["tolerance"])
    elif kind == "box":
        ids = pt.select_nodes_by_box(grid, selection["min"], selection["max"],
                                     selection["tolerance"])
    elif kind == "circle":
        ids = pt.select_nodes_by_circle(grid, selection["center"],
                                        selection["normal"],
                                        selection["radius"],
                                        selection["tolerance"])
    elif kind == "closest":
        ids = np.array([pt.closest_node(grid, selection["point"])])
    else:
        raise ValueError(f"unknown node selection {kind!r}")
    if len(ids) == 0:
        raise ValueError(f"the selection {selection} takes no node")
    return ids


def boundary(pt, grid, config, nels):
    """(boundary conditions, loads) of the configuration on `grid`, the
    port's grid of `nels` unit cubes or its tet mesh: each support through
    the port's selectors and `apply_sliding_boundary` with its components,
    the load as one `PointLoad`."""
    bcs = [pt.apply_sliding_boundary(
        grid, _nodes(pt, grid, in_grid(support["nodes"], config, nels)),
        support["components"]) for support in config["supports"]]
    load = config["load"]
    return bcs, [pt.PointLoad(
        _nodes(pt, grid, in_grid(load["nodes"], config, nels)),
        load["total_force"])]
