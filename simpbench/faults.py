"""Faults planted in the timed path to show that `correct` catches them.

Each fault wraps a system's `one_step` (the function, not the bound
method) and returns the broken one.  A SIMP iteration has no batch and a
one-card cell no exchange between cards, so the faults a cell can have
are these: the step returns its state unchanged, or alters an answer
where it is produced (the design, the displacements, the energy).
"""

from __future__ import annotations

import types


def unchanged(step):
    def broken(self):
        before = tuple(t.clone() for t in self.fields())
        energy, cg = step(self)
        if hasattr(self, "st"):
            self.st.design, self.st.u = before
        else:
            self.design, self.u = before
        return energy, cg
    return broken


def design_altered(step):
    def broken(self):
        energy, cg = step(self)
        self.fields()[0].view(-1)[0] += 0.2
        return energy, cg
    return broken


def displacements_altered(step):
    def broken(self):
        energy, cg = step(self)
        self.fields()[1].mul_(1.2)
        return energy, cg
    return broken


def energy_altered(step):
    def broken(self):
        energy, cg = step(self)
        return energy * 1.1, cg
    return broken


FAULTS = {f.__name__: f for f in (unchanged, design_altered,
                                  displacements_altered, energy_altered)}


def for_cell(cell):
    """The faults whose answer the cell compares: the energy only where
    its limits hold `energy_gap`."""
    return [name for name in FAULTS
            if name != "energy_altered" or "energy_gap" in cell.limits]


def plant(system, name):
    """Break one system instance's `one_step` with the fault `name`."""
    system.one_step = types.MethodType(
        FAULTS[name](type(system).one_step), system)
