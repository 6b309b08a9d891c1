"""Device meshes, shard layouts and sharded fields.

Counterpart of easysimp_tpu/parallel/sharding.py.  The reference runs one
jitted program over a `jax.sharding.Mesh` and lets GSPMD partition it; the
port is single-controller too, but explicit: one process drives a mesh of
`torch.device`s, and every shard keeps its block of each field on its own
device.  A device may occur several times in a mesh (several shards on one
card, or `["cpu"] * 8` in the tests).

Layouts (mesh axes ("x", "y", "z") <-> grid axes 0, 1, 2):
  cells  split evenly: shard k of an axis owns cells [k l, (k+1) l), l =
         n / P, as `cell_sharding` splits them;
  nodes  split by ownership: shard k owns node planes [k l, (k+1) l), and the
         last shard also owns the final plane (easysimp_tpu/parallel/
         halo.py:10-19).
Every node and cell has exactly one owner, so reductions over owned blocks
count each once.  The padded node storage of the reference's
`node_sharding`/`shard_voxel_state` exists because GSPMD rejects uneven
shardings; explicit blocks take uneven node counts directly, so it has no
counterpart.  Imported meshes split their elements into contiguous runs
over a 1-axis ("e",) mesh (`make_element_mesh`).

`ShardedField` holds the blocks of one field.  It takes part in PyTorch's
`__torch_function__` protocol: an elementwise op on sharded fields runs on
each shard's blocks, on that shard's device (a 0-d or other small tensor
from elsewhere is moved there); `sum`, `mean`, `max`, `min` over the whole
field and `torch.dot` are global: per-shard partials added (or compared) in
shard order on the mesh's first device.  The ops that run per shard are an
allow-list (`_PER_SHARD`), and a per-shard result must keep a known layout;
every other op (reshape, pad, permute, std, sort, softmax, slicing a
spatial axis, ...) raises.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DeviceMesh",
    "GridLayout",
    "ElementLayout",
    "ShardedField",
    "best_mesh_shape",
    "make_mesh",
    "make_element_mesh",
    "mesh_device",
    "round_robin_cards",
]

_AXES = ("x", "y", "z")


def best_mesh_shape(n_devices: int, nels, max_axes: int = 3):
    """Factor n_devices over the largest grid axes (slab, then pencil, then
    cube); the reference's rule (easysimp_tpu/parallel/sharding.py:40-65)."""
    order = np.argsort(nels)[::-1]
    shape = [1, 1, 1]
    remaining = n_devices
    for ax in order[:max_axes]:
        if remaining == 1:
            break
        # largest divisor of `remaining` that divides nels[ax]
        d = 1
        for cand in range(min(remaining, nels[ax]), 0, -1):
            if remaining % cand == 0 and nels[ax] % cand == 0:
                d = cand
                break
        shape[ax] = d
        remaining //= d
    if remaining != 1:
        raise ValueError(
            f"cannot factor {n_devices} devices over grid {tuple(nels)}")
    return tuple(shape)


class DeviceMesh:
    """A grid of `torch.device`s with named axes: ("x", "y", "z") for voxel
    grids, ("e",) for imported meshes.  `devices` is a numpy object array;
    `shape` maps axis name -> size, as a jax Mesh's does."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"DeviceMesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def _devices(devices, n_devices):
    """The mesh's device list: explicit ones (strings or torch.devices, may
    repeat), or every visible CUDA card.  CUDA devices that do not exist
    raise: a mesh never moves to the CPU on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass devices= "
                               "(e.g. ['cpu'] * 8) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} "
                             f"given")
        devices = devices[:n_devices]
    for d in devices:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh names {d} but no CUDA device is "
                                   f"available")
            if (d.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"mesh names {d} but only "
                                   f"{torch.cuda.device_count()} CUDA "
                                   f"device(s) exist")
    return devices


def round_robin_cards(n: int) -> list:
    """n shard devices over the visible CUDA cards, round-robin (one card
    holds all n when it is the only one)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: pass devices= (e.g. ['cpu'] * "
                           f"{n})")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def make_mesh(n_devices: int | None = None, shape=None,
              devices=None) -> DeviceMesh:
    """An ("x", "y", "z") device mesh.

    Args:
      n_devices: number of shards (default: all given devices).
      shape: (dx, dy, dz) factorization; default (n, 1, 1).
      devices: device list (default: the visible CUDA cards); may repeat a
        device, e.g. ["cuda:0"] * 4 or ["cpu"] * 8.
    """
    devices = _devices(devices, n_devices)
    n = len(devices)
    if shape is None:
        shape = (n, 1, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(tuple(shape)), _AXES)


def make_element_mesh(n_elements: int, n_devices=None,
                      devices=None) -> DeviceMesh:
    """1-axis ("e",) mesh over the element axis of an imported mesh, with
    the largest shard count that divides n_elements (the reference's rule,
    easysimp_tpu/parallel/sharding.py:146-160)."""
    devices = _devices(devices, None)
    n = len(devices) if n_devices is None else int(n_devices)
    n = min(n, len(devices))
    while n > 1 and n_elements % n:
        n -= 1
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return DeviceMesh(arr, ("e",))


_MESH_FOR = {
    ("x", "y", "z"): "voxel grids need an ('x','y','z') device mesh "
                     "(parallel.sharding.make_mesh)",
    ("e",): "unstructured meshes need a 1-axis ('e',) element device mesh "
            "(parallel.sharding.make_element_mesh)",
}


def mesh_device(mesh, device, axes) -> torch.device:
    """The first device of `mesh`, after checking that the mesh has the
    `axes` the input kind needs (the reference's messages) and that
    `device` agrees with it (same type; same index when one is given)."""
    got = tuple(getattr(mesh, "axis_names", ()))
    if got != tuple(axes):
        raise ValueError(f"{_MESH_FOR[tuple(axes)]}, got axes {got}")
    first = torch.device(mesh.devices.flat[0])
    want = torch.device(device)
    if want.type != first.type or (want.index is not None
                                   and want.index != (first.index or 0)):
        raise ValueError(f"device={str(want)!r} disagrees with the mesh, "
                         f"whose first device is {first}")
    return first


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------

# spatial axes of a block, counted from its end, by field kind: cell fields
# (..., nx, ny, nz), node fields (..., nnx, nny, nnz, 3), node coefficient
# fields such as stencils (..., nnx, nny, nnz)
_SPATIAL = {"cell": (-3, -2, -1), "node": (-4, -3, -2), "coef": (-3, -2, -1)}
_RANGES = {"cell": "cell", "node": "node", "coef": "node"}
# the element axis of an element-split field, by kind: first (element
# batches such as ke), or last, after batch axes (the OC's candidates)
_ELEM_AXIS = {"elem": 0, "elem_last": -1}


def _split_axes(kind, nd):
    """The split axes (as non-negative indices) of an nd-dim block."""
    if kind in _ELEM_AXIS:
        return {_ELEM_AXIS[kind] % nd}
    return {nd + a for a in _SPATIAL[kind]}


class GridLayout:
    """How a voxel grid of `nels` cells splits over an ("x","y","z") mesh:
    per axis and mesh coordinate, the owned cell and node ranges.  Shards
    are numbered in C order of their mesh coordinates (the order of every
    reduction)."""

    def __init__(self, mesh: DeviceMesh, nels):
        if mesh.axis_names != _AXES:
            raise ValueError(f"voxel grids need an ('x','y','z') device "
                             f"mesh, got axes {mesh.axis_names}")
        self.mesh = mesh
        self.nels = tuple(int(n) for n in nels)
        self.mesh_shape = tuple(mesh.devices.shape)
        self.cell_ranges, self.node_ranges = [], []
        for n, p in zip(self.nels, self.mesh_shape):
            if n % p:
                raise ValueError(f"grid {self.nels} does not split evenly "
                                 f"over mesh {self.mesh_shape}")
            width = n // p
            self.cell_ranges.append([(k * width, (k + 1) * width)
                                     for k in range(p)])
            self.node_ranges.append([(k * width, (k + 1) * width
                                      + (k == p - 1)) for k in range(p)])
        self.coords = list(np.ndindex(*self.mesh_shape))
        self.devices = [mesh.devices[c] for c in self.coords]
        self.device = self.devices[0]
        self.n_shards = len(self.coords)

    def extent(self, kind):
        """Global sizes of the split axes for a field kind."""
        return (self.nels if _RANGES[kind] == "cell"
                else tuple(n + 1 for n in self.nels))

    def ranges(self, kind, i):
        """Owned (lo, hi) per axis of shard i for a field kind."""
        table = (self.cell_ranges if _RANGES[kind] == "cell"
                 else self.node_ranges)
        return [table[a][self.coords[i][a]] for a in range(3)]

    def block_shape(self, kind, i):
        return tuple(hi - lo for lo, hi in self.ranges(kind, i))

    def split(self, t, kind) -> "ShardedField":
        """A global tensor (or numpy array) -> its owned blocks, each on its
        shard's device."""
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.ascontiguousarray(t))
        axes = [t.dim() + a for a in _SPATIAL[kind]]
        blocks = []
        for i, dev in enumerate(self.devices):
            b = t
            for ax, (lo, hi) in zip(axes, self.ranges(kind, i)):
                b = b.narrow(ax, lo, hi - lo)
            blocks.append(b.to(dev).contiguous())
        return ShardedField(blocks, self, kind)

    def gather(self, f: "ShardedField", device=None) -> torch.Tensor:
        """The global tensor of a sharded field, on `device` (default: the
        mesh's first device)."""
        device = self.device if device is None else torch.device(device)
        b0 = f.blocks[0]
        out = b0.new_empty(f.shape, device=device)
        axes = [b0.dim() + a for a in _SPATIAL[f.kind]]
        for i, b in enumerate(f.blocks):
            view = out
            for ax, (lo, hi) in zip(axes, self.ranges(f.kind, i)):
                view = view.narrow(ax, lo, hi - lo)
            view.copy_(b)
        return out

    def full(self, value, kind, dtype, trailing=()):
        """A constant sharded field (no host round trip)."""
        return ShardedField(
            [torch.full((*self.block_shape(kind, i), *trailing), value,
                        dtype=dtype, device=dev)
             for i, dev in enumerate(self.devices)], self, kind)


class ElementLayout:
    """Contiguous runs of elements over a ("e",) mesh: shard k owns elements
    [k E/P, (k+1) E/P) (P divides E, see `make_element_mesh`)."""

    def __init__(self, mesh: DeviceMesh, n_elements: int):
        if mesh.axis_names != ("e",):
            raise ValueError(f"imported meshes need a 1-axis ('e',) element "
                             f"device mesh, got axes {mesh.axis_names}")
        p = mesh.size
        if n_elements % p:
            raise ValueError(f"{n_elements} elements do not split over "
                             f"{p} shards")
        width = n_elements // p
        self.mesh = mesh
        self.n_elements = n_elements
        self.elem_ranges = [(k * width, (k + 1) * width) for k in range(p)]
        self.devices = list(mesh.devices.flat)
        self.device = self.devices[0]
        self.n_shards = p

    def split(self, t) -> "ShardedField":
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.ascontiguousarray(t))
        return ShardedField([t[lo:hi].to(dev).contiguous() for (lo, hi), dev
                             in zip(self.elem_ranges, self.devices)],
                            self, "elem")

    def gather(self, f: "ShardedField", device=None) -> torch.Tensor:
        device = self.device if device is None else torch.device(device)
        return torch.cat([b.to(device) for b in f.blocks],
                         dim=_ELEM_AXIS[f.kind])


# --------------------------------------------------------------------------
# Sharded fields
# --------------------------------------------------------------------------

# whole-field reductions with global meaning
_GLOBAL = {"sum", "mean", "max", "amax", "min", "amin", "dot", "vdot"}
# ops that run on each shard's blocks: elementwise ones (a 0-d or other
# small operand is moved to the shard's device), ones that keep the layout
# (dtype casts, copies, *_like), and joins and contractions along a leading
# batch axis, whose result must keep a known layout (`_wrap`).  Every other
# op raises: its meaning could change under a split.
_PER_SHARD = {
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__pow__", "__rpow__", "__neg__",
    "__abs__", "__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__",
    "__and__", "__or__", "__xor__", "__invert__",
    "add", "sub", "subtract", "mul", "multiply", "div", "divide",
    "true_divide", "neg", "negative", "abs", "pow", "square", "sqrt",
    "rsqrt", "reciprocal", "exp", "expm1", "log", "log1p", "sin", "cos",
    "tanh", "sigmoid", "sign", "floor", "ceil", "round", "clamp", "clip",
    "clamp_min", "clamp_max", "maximum", "minimum", "where", "lerp",
    "addcmul", "addcdiv", "nan_to_num", "isfinite", "isnan", "isinf", "eq",
    "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not",
    "to", "type", "float", "double", "half", "bfloat16", "contiguous",
    "clone", "detach", "zeros_like", "ones_like", "full_like", "empty_like",
    "cat", "concat", "concatenate", "stack", "unsqueeze", "tensordot",
}
def _first_field(obj):
    if isinstance(obj, ShardedField):
        return obj
    if isinstance(obj, (list, tuple)):
        for o in obj:
            f = _first_field(o)
            if f is not None:
                return f
    if isinstance(obj, dict):
        return _first_field(list(obj.values()))
    return None


def _sub(obj, i, dev, layout):
    """obj with every ShardedField replaced by its block i and every other
    tensor moved to `dev`."""
    if isinstance(obj, ShardedField):
        if obj.layout is not layout:
            raise ValueError("sharded fields of different layouts combined")
        return obj.blocks[i]
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == dev else obj.to(dev)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_sub(o, i, dev, layout) for o in obj)
    if isinstance(obj, dict):
        return {k: _sub(v, i, dev, layout) for k, v in obj.items()}
    return obj


def _infer_kind(blocks, layout, prefer):
    """The kind whose owned block shapes sit at the blocks' spatial axes
    (the preferred one first), or None."""
    if isinstance(layout, ElementLayout):
        for kind in sorted(_ELEM_AXIS, key=lambda k: k != prefer):
            if all(b.dim() >= 1 and b.shape[_ELEM_AXIS[kind]] == hi - lo
                   for b, (lo, hi) in zip(blocks, layout.elem_ranges)):
                return kind
        return None
    for kind in sorted(_SPATIAL, key=lambda k: k != prefer):
        need = -min(_SPATIAL[kind])
        if all(b.dim() >= need and tuple(b.shape[a] for a in _SPATIAL[kind])
               == layout.block_shape(kind, i) for i, b in enumerate(blocks)):
            return kind
    return None


def _add_in_order(parts, device):
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


class ShardedField:
    """The blocks of one field over a mesh, one per shard, each on its
    shard's device (see the module docstring for the ops it supports)."""

    def __init__(self, blocks, layout, kind):
        self.blocks = list(blocks)
        self.layout = layout
        self.kind = kind

    # ----- torch protocol -------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        first = _first_field((args, kwargs))
        if name in _GLOBAL:
            return first._reduce(name, args, kwargs)
        if name not in _PER_SHARD:
            raise TypeError(f"{name} is not defined on a sharded field")
        if name in ("cat", "concat", "concatenate"):
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            if dim != 0 or 0 in _split_axes(first.kind,
                                            first.blocks[0].dim()):
                raise TypeError("sharded fields concatenate along a leading "
                                "batch axis only")
        return first._map(func, args, kwargs)

    def _map(self, func, args, kwargs):
        outs = []
        for i, dev in enumerate(self.layout.devices):
            outs.append(func(*_sub(args, i, dev, self.layout),
                             **_sub(kwargs, i, dev, self.layout)))
        return self._wrap(outs)

    def _wrap(self, outs):
        o = outs[0]
        if isinstance(o, torch.Tensor):
            kind = _infer_kind(outs, self.layout, self.kind)
            if kind is None:
                raise TypeError(f"per-shard results of shapes "
                                f"{[tuple(b.shape) for b in outs]} lost the "
                                f"field's layout")
            return ShardedField(outs, self.layout, kind)
        if isinstance(o, (tuple, list)):
            return tuple(self._wrap([out[j] for out in outs])
                         for j in range(len(o)))
        if all(out == o for out in outs):
            return o
        raise TypeError(f"per-shard results differ: {outs}")

    def _reduce(self, name, args, kwargs):
        dev = self.layout.device
        if name in ("dot", "vdot"):
            a, b = args[0], args[1]
            if not (isinstance(a, ShardedField)
                    and isinstance(b, ShardedField)):
                raise TypeError("dot of a sharded and a plain tensor")
            return _add_in_order([torch.dot(x.reshape(-1), y.reshape(-1))
                                  for x, y in zip(a.blocks, b.blocks)], dev)
        if len(args) > 1 or kwargs:
            dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
            dims = dims if isinstance(dims, (tuple, list)) else (dims,)
            nd = self.blocks[0].dim()
            split = _split_axes(self.kind, nd)
            if dims[0] is None or any(
                    (d % nd) in split for d in dims):
                raise TypeError(f"{name} over a split axis of a sharded "
                                f"field: use field_sums")
            return self._map(getattr(torch.Tensor, name), args, kwargs)
        if name == "sum":
            return _add_in_order([b.sum() for b in self.blocks], dev)
        if name == "mean":
            n = sum(b.numel() for b in self.blocks)
            return _add_in_order([b.sum() for b in self.blocks], dev) / n
        parts = torch.stack([b.amax() if name in ("max", "amax") else b.amin()
                             for b in (x.to(dev) for x in self.blocks)])
        return parts.amax() if name in ("max", "amax") else parts.amin()

    # ----- explicit global and per-shard operations -------------------------
    def vdot(self, other):
        """Global <self, other>: per-shard dots added in shard order."""
        return torch.dot(self, other)

    def gram(self, other):
        """(m, n) matrix of <self_i, other_j> for stacked fields (m, ...)
        and (n, ...): per-shard products added in shard order."""
        m, n = self.blocks[0].shape[0], other.blocks[0].shape[0]
        return _add_in_order([a.reshape(m, -1) @ b.reshape(n, -1).T
                              for a, b in zip(self.blocks, other.blocks)],
                             self.layout.device)

    def field_sums(self, dims):
        """Sums over `dims`, which cover the split axes: per-shard partial
        sums added in shard order (e.g. the OC's candidate volumes)."""
        return _add_in_order([b.sum(dim=dims) for b in self.blocks],
                             self.layout.device)

    def map(self, fn, *others):
        """fn(block, *other blocks) on every shard; returns a field (or a
        tuple of fields)."""
        return self._map(lambda *a: fn(*a), (self, *others), {})

    def gather(self, device=None):
        return self.layout.gather(self, device)

    # ----- tensor-like surface ----------------------------------------------
    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        """The mesh's first device (where global results live)."""
        return self.layout.device

    @property
    def shape(self):
        shape = list(self.blocks[0].shape)
        if self.kind in _ELEM_AXIS:
            a = _ELEM_AXIS[self.kind]
            shape[a] = sum(x.shape[a] for x in self.blocks)
        else:
            for a, n in zip(_SPATIAL[self.kind],
                            self.layout.extent(self.kind)):
                shape[a] = n
        return torch.Size(shape)

    def dim(self):
        return self.blocks[0].dim()

    def __getitem__(self, key):
        keys = key if isinstance(key, tuple) else (key,)
        if self.kind != "elem":
            lead = min(_split_axes(self.kind, self.blocks[0].dim()))
            used = [k for k in keys if k is not None]
            if any(k is Ellipsis for k in used) or len(used) > lead:
                raise TypeError("indexing a sharded field along its split "
                                "axes")
        elif not (
                all(k is None for k in keys) or keys[0] == slice(None)):
            raise TypeError("indexing an element-sharded field along its "
                            "split axis")
        return self._map(torch.Tensor.__getitem__, (self, key), {})

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        meth = getattr(torch.Tensor, name, None)
        if not callable(meth):
            raise AttributeError(name)
        return lambda *a, **k: ShardedField.__torch_function__(
            meth, (ShardedField,), (self, *a), k)

    def __repr__(self):
        return (f"ShardedField({self.kind}, {len(self.blocks)} shards, "
                f"{self.dtype})")


def _binary(name):
    meth = getattr(torch.Tensor, name)

    def op(self, *args):
        return ShardedField.__torch_function__(meth, (ShardedField,),
                                               (self, *args), {})
    op.__name__ = name
    return op


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__pow__",
              "__rpow__", "__neg__", "__abs__", "__lt__", "__le__", "__gt__",
              "__ge__", "__and__", "__or__", "__invert__"):
    setattr(ShardedField, _name, _binary(_name))
del _name
