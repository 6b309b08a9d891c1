"""Spans and counters of the port, on the profiler's clock.

`span(name)` marks a stretch of host code, `spanned(name)` every call of a
function.  While a `torch.profiler` session is recording, a span enters
`torch.profiler.record_function(PREFIX + name)`, so it lands in the
profiler's chrome trace beside the device operations it launched, on the
same clock and tied to them by correlation id (also in the trace that
`OptimizationParameters.profile_dir` writes).  With no session it costs
one check and a shared no-op.  Nothing is kept or written here: the
profiler holds the spans and exports them.

Counters are plain integers in one module-level table, always on:
`count(name, n)` adds, `counters()` returns a copy.  `host_read(name, t)`
is the one way the hot path reads a device value on the host: it reads
`t` inside span `sync.<name>` and counts `sync.<name>`; `sync(name)` does
the same around a call that synchronises by itself.

Spans (nested as the code nests them): `cg`, `cg.deflate`; `mg.vcycle`,
`mg.smooth.<l>`, `mg.stencil.<l>`, `mg.transfer.<l>`, `mg.coarsest`;
`setup.full`, `setup.light`; `filter`; `sens`; `oc`, `oc.pass`;
`op.apply`; `amg.setup`, `amg.vcycle`; `halo.extend`; `sync.<site>`.
Counters: `cg.iterations`, `steps` (SIMP iterations), `sync.<site>`,
`launch.voxel_matvec.<dtype>`, `launch.voxel_energies.<dtype>`,
`launch.element_apply.<dtype>`, `launch.stencil_apply.<dtype>` (the
stencil's dtype) and `bytes.stencil_apply` (the bytes those launches read
and write, each tensor once); `setup.full` and `setup.light` (voxel
preconditioner setups), `setup.watchdog` (the full setups a degraded CG
count forced); `mg.graph.capture`, `mg.graph.replay` and `mg.graph.eager`,
one per multigrid M(r) call by the path it took (ops/multigrid.py
`make_M`: the capture of a hierarchy's V-cycle graph, a replay of it, or
the eager cycle); the capture's wait is `sync.mg_capture`.

A replayed V-cycle runs no Python: it enters none of the spans inside
`mg.vcycle` (`mg.smooth.<l>`, `mg.transfer.<l>`, `mg.stencil.<l>`,
`mg.coarsest`), which on one CUDA device therefore time only eager cycles.
Its counters are kept all the same: each replay adds what the captured
cycle counted (the capture itself counts nothing), so the `launch.*` and
`bytes.*` counters count the launches the device makes, replayed or not.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

__all__ = ["PREFIX", "span", "spanned", "sync", "host_read", "count",
           "counters"]

PREFIX = "easysimp:"

_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts = collections.Counter()


def span(name):
    """Context manager around the host code of span `name`."""
    if not _enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name):
    """Decorator: every call of the function runs inside span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, n=1):
    """Add `n` to counter `name`."""
    _counts[name] += n


def counters():
    """A copy of every counter."""
    return dict(_counts)


def sync(name):
    """Counter `sync.<name>`, and its span around the call that waits for
    the device: `with sync(name): ...`."""
    key = "sync." + name
    _counts[key] += 1
    return span(key)


def host_read(name, tensor):
    """The value of `tensor` on the host (a wait for the device), counted
    and spanned as `sync.<name>`: a Python number for a 0-d tensor, a CPU
    tensor otherwise."""
    with sync(name):
        return tensor.item() if tensor.dim() == 0 else tensor.cpu()
