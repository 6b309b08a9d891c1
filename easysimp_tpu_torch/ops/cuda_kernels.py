"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their builds.

Counterparts of easysimp_tpu/ops/pallas_kernels.py:

  voxel_matvec    replaces `_kernel` (make_pallas_matvec,
                  easysimp_tpu/ops/pallas_kernels.py:183-342): the fused SIMP
                  stiffness matvec K(rho) u on a hex8 voxel grid.
  voxel_energies  replaces `_energies_kernel` (make_pallas_energies,
                  easysimp_tpu/ops/pallas_kernels.py:345-430): the per-element
                  quadratic u_e^T ke u_e.

and two kernels that replace no Pallas kernel:

  element_apply   the unstructured operator's element product s_e ke_e u_e
                  with its own d x d matrix per element (tet4 / hex8 meshes),
                  which the JAX package leaves to XLA's einsum; the port's
                  gather -> torch.bmm -> scale streamed the matrices at a
                  tenth of the card's bandwidth.
  stencil_apply   the multigrid's masked Galerkin stencil apply M C (M x),
                  or r - M C (M x), which the JAX package leaves to XLA; the
                  port's unfold view x C -> sum wrote and re-read a transient
                  the size of C, at 8-18% of the card's bandwidth.

The voxel kernels are CUDA C++ for sm_90a in `csrc/voxel_kernels.cu`, the
element kernel in `csrc/element_apply.cu`, the stencil kernel in
`csrc/stencil_apply.cu`; each source says what bounds its kernels on an
H100 and what their design does about it.  For float32 and bfloat16
storage the voxel kernels run the element product on the tensor cores in
3xTF32 (`tf32_round` below states that arithmetic in PyTorch); for float64
they are simple kernels on the FP64 CUDA cores.  The element and stencil
kernels stream their coefficients once and sum on the CUDA cores.
Each source file is built at first use with `nvcc` into its own shared
library with a plain C interface, under `_build/` keyed by a hash of that
source alone (`library_path`), and loaded with ctypes.

Each wrapper dispatches on the device of its tensors: a CPU tensor takes the
plain version (the reference XLA path's gather -> product -> scatter-add,
written in PyTorch), a CUDA tensor launches the kernel or raises.  There is
no fallback: a missing `nvcc`, a failed build or a refused launch raises.
Each launch adds one to the port's counter `launch.<kernel>.<storage dtype>`
(`tracing.counters()`, for example `launch.voxel_matvec.bfloat16`);
`launches` sums them.

bf16 storage computes in fp32, as the Pallas kernels do: the voxel wrappers
take `ke` in the compute dtype (float64 for float64 storage, float32
otherwise); the element kernel reads its matrices, the stencil kernel its
coefficients, in the storage dtype.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..tracing import count, counters
from .elements import HEX_CORNERS
from .stencil import apply_stencil

__all__ = [
    "compute_dtype",
    "gather_element_dofs",
    "scatter_element_dofs",
    "voxel_matvec",
    "voxel_matvec_plain",
    "voxel_energies",
    "voxel_energies_plain",
    "centre_element_dofs",
    "element_apply",
    "element_apply_plain",
    "stencil_apply",
    "stencil_apply_plain",
    "tf32_round",
    "build_kernels",
    "build_element_kernels",
    "build_stencil_kernels",
    "library_path",
    "launches",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_COUNTER = {k: {dt: f"launch.{k}.{str(dt)[6:]}" for dt in _SUFFIX}
            for k in ("voxel_matvec", "voxel_energies", "element_apply",
                      "stencil_apply")}
_LIBRARIES = {"voxel_kernels": ("voxel_kernels.cu",),
              "element_apply": ("element_apply.cu",),
              "stencil_apply": ("stencil_apply.cu",)}
_ELEMENT_WIDTHS = (12, 24)   # dofs per element: tet4, hex8


def launches(kernel, dtype=None):
    """Launches of `kernel` ("voxel_matvec", "voxel_energies",
    "element_apply" or "stencil_apply", counted by the stencil's dtype) so
    far, of one storage dtype or of all."""
    c = counters()
    return sum(c.get(name, 0) for dt, name in _COUNTER[kernel].items()
               if dtype is None or dt == dtype)


_libs: dict = {}       # the loaded libraries (each built at first CUDA use)
build_info: dict = {}  # per library: path, seconds and compiler output


def compute_dtype(storage_dtype: torch.dtype) -> torch.dtype:
    """fp32 for sub-32-bit storage, the storage dtype otherwise."""
    return torch.float32 if storage_dtype == torch.bfloat16 else storage_dtype


# --------------------------------------------------------------------------
# Plain versions (the reference XLA path, easysimp_tpu/ops/operator.py:39-60,
# 109-135).  The CPU path and the tests use them; chip_smoke.py holds each
# kernel against its plain version on the card.
# --------------------------------------------------------------------------

def gather_element_dofs(u):
    """Node field (nnx, nny, nnz, 3) -> element dofs (nx, ny, nz, 24),
    node-major in hex corner order (the layout of `hex8_stiffness`)."""
    nx, ny, nz = u.shape[0] - 1, u.shape[1] - 1, u.shape[2] - 1
    return torch.cat([u[dx:dx + nx, dy:dy + ny, dz:dz + nz, :]
                      for dx, dy, dz in HEX_CORNERS], dim=-1)


def scatter_element_dofs(fe):
    """Transpose of `gather_element_dofs`: (nx, ny, nz, 24) -> node field."""
    nx, ny, nz = fe.shape[:3]
    out = fe.new_zeros((nx + 1, ny + 1, nz + 1, 3))
    for c, (dx, dy, dz) in enumerate(HEX_CORNERS):
        out[dx:dx + nx, dy:dy + ny, dz:dz + nz, :] += fe[..., 3 * c:3 * c + 3]
    return out


def voxel_matvec_plain(u, scale, ke):
    """K(scale) u: gather -> (N,24)@(24,24) -> modulus scale -> scatter-add,
    computed in ke's dtype and returned in u's."""
    ue = gather_element_dofs(u).to(ke.dtype)
    q = (ue.reshape(-1, 24) @ ke).reshape(ue.shape)     # ke symmetric
    return scatter_element_dofs(q * scale.to(ke.dtype)[..., None]).to(u.dtype)


def centre_element_dofs(ue):
    """Element dofs (..., 24) less their element's mean displacement (each
    component's mean over the 8 corners).  ke annihilates translations, so
    u_e^T ke u_e is unchanged, but a displacement field that carries a large
    near-rigid motion (a simply supported beam's deflection) no longer
    cancels away the energy's leading digits."""
    corners = ue.unflatten(-1, (8, 3))
    return (corners - corners.mean(dim=-2, keepdim=True)).flatten(-2)


def voxel_energies_plain(u, ke):
    """u_e^T ke u_e per element, (nx, ny, nz), computed in ke's dtype from
    the centred element dofs (`centre_element_dofs`)."""
    ue = centre_element_dofs(gather_element_dofs(u).to(ke.dtype))
    q = (ue.reshape(-1, 24) @ ke).reshape(ue.shape)
    return (ue * q).sum(dim=-1).to(u.dtype)


def element_apply_plain(u, conn, ke, scale=None, mask=None):
    """`element_apply` in plain tensor code on any device: mask, gather,
    batched ke_e @ u_e (`torch.bmm`), scale, then the zero row appended."""
    if mask is not None:
        u = mask * u
    ue = u.reshape(-1, 3)[conn].reshape(ke.shape[:2])
    q = torch.bmm(ke, ue.unsqueeze(-1)).squeeze(-1)
    if scale is not None:
        q = q * scale[:, None]
    return torch.cat([q.reshape(-1, 3), q.new_zeros((1, 3))])


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` rounds; returned as float32.

    The float32 and bfloat16 kernels form q_e = ke u_e on the tensor cores
    from such values, in 3xTF32: with hi = tf32_round(x) and
    lo = tf32_round(x - hi) for both operands, q = a_lo b_hi + a_hi b_lo +
    a_hi b_hi, each product exact and the sums in float32 (the dropped
    a_lo b_lo is ~2^-22 relative).  bfloat16 values are exact in TF32, so
    a_lo = 0 for bfloat16 storage."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # + half an ulp of TF32 to the magnitude bits, then cut the low 13 bits
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "voxel CUDA kernels cannot be built")
    return path


def library_path(name):
    """(sources, shared library path) of kernel library `name`
    ("voxel_kernels", "element_apply" or "stencil_apply").  Each library is
    built from its own sources alone, under a name keyed by their hash, so
    an edited source rebuilds only its library and an unchanged one is
    reused."""
    sources = [_CSRC / f for f in _LIBRARIES[name]]
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return sources, _BUILD / f"{name}_{digest.hexdigest()[:16]}.so"


def _load(name):
    """Build (if needed) and load library `name`; raises on any failure."""
    sources, so = library_path(name)
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    build_info[name] = dict(path=str(so), seconds=time.perf_counter() - t0,
                            log=log)
    return lib


def _library(name, signatures):
    """Library `name`, built and loaded at first use, with the argument
    types of each function from `signatures` {symbol: argtypes}; every
    function returns a C int."""
    lib = _libs.get(name)
    if lib is None:
        lib = _load(name)
        for symbol, argtypes in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def build_kernels():
    """Build (if needed) and load the voxel kernels' shared library,
    `_build/voxel_kernels_<hash>.so`.  Raises on any failure."""
    matvec = [_PTR] * 4 + [_INT] * 3 + [_PTR]
    signatures = {}
    for sfx in _SUFFIX.values():
        signatures[f"voxel_matvec_{sfx}"] = matvec
        signatures[f"voxel_energies_{sfx}"] = [_PTR] * 3 + [_INT] * 3 + [_PTR]
    return _library("voxel_kernels", signatures)


def build_element_kernels():
    """Build (if needed) and load the element kernel's shared library,
    `_build/element_apply_<hash>.so`.  Raises on any failure."""
    return _library("element_apply", {
        f"element_apply_{sfx}": [_PTR] * 6 + [ctypes.c_longlong, _INT, _PTR]
        for sfx in _SUFFIX.values()})


def build_stencil_kernels():
    """Build (if needed) and load the stencil kernel's shared library,
    `_build/stencil_apply_<hash>.so`: one function per pair of stencil and
    field dtypes.  Raises on any failure."""
    return _library("stencil_apply", {
        f"stencil_apply_{a}_{b}": [_PTR] * 5 + [_INT] * 3 + [_PTR]
        for a in _SUFFIX.values() for b in _SUFFIX.values()})


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _check_cuda(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_field(u):
    """Checks the node field u and returns the element counts."""
    if u.dtype not in _SUFFIX:
        raise TypeError(f"unsupported storage dtype {u.dtype}; expected one "
                        f"of {list(_SUFFIX)}")
    if u.dim() != 4 or u.shape[-1] != 3 or min(u.shape[:3]) < 2:
        raise ValueError(f"u must be a (nnx, nny, nnz, 3) node field with "
                         f"every nn >= 2, got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if u.numel() >= 2**31:
        raise ValueError("node field too large for the kernels' int32 "
                         "element indices")
    return tuple(s - 1 for s in u.shape[:3])


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _launch_matvec(symbol, u, scale, ke):
    nx, ny, nz = _check_field(u)
    _check_cuda("scale", scale, u.dtype, (nx, ny, nz), u.device)
    _check_cuda("ke", ke, compute_dtype(u.dtype), (24, 24), u.device)
    lib = build_kernels()
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            u.data_ptr(), scale.data_ptr(), ke.data_ptr(), out.data_ptr(),
            nx, ny, nz, stream)
    _raise_on(err, symbol)
    return out


def voxel_matvec(u, scale, ke):
    """K(rho) u on a hex8 voxel grid, with scale = E(rho) per element.

    u: (nnx, nny, nnz, 3), scale: (nx, ny, nz) in the same storage dtype;
    ke: (24, 24) in `compute_dtype(u.dtype)`.  CPU tensors take
    `voxel_matvec_plain`; CUDA tensors launch the kernel."""
    if u.device.type == "cpu":
        return voxel_matvec_plain(u, scale, ke)
    if u.device.type != "cuda":
        raise ValueError(f"no voxel_matvec for device {u.device}")
    out = _launch_matvec(f"voxel_matvec_{_SUFFIX[u.dtype]}", u, scale, ke)
    count(_COUNTER["voxel_matvec"][u.dtype])
    return out


def voxel_energies(u, ke):
    """u_e^T ke u_e per element, (nx, ny, nz), in u's storage dtype, from
    the centred element dofs (`centre_element_dofs`).

    ke: (24, 24) in `compute_dtype(u.dtype)`.  CPU tensors take
    `voxel_energies_plain`; CUDA tensors launch the kernel."""
    if u.device.type == "cpu":
        return voxel_energies_plain(u, ke)
    if u.device.type != "cuda":
        raise ValueError(f"no voxel_energies for device {u.device}")
    nx, ny, nz = _check_field(u)
    _check_cuda("ke", ke, compute_dtype(u.dtype), (24, 24), u.device)
    lib = build_kernels()
    out = u.new_empty((nx, ny, nz))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"voxel_energies_{_SUFFIX[u.dtype]}")(
            u.data_ptr(), ke.data_ptr(), out.data_ptr(), nx, ny, nz, stream)
    _raise_on(err, "voxel_energies")
    count(_COUNTER["voxel_energies"][u.dtype])
    return out


def _check_elements(u, conn, ke, scale, mask):
    """Checks `element_apply`'s arguments; returns (n_elem, d)."""
    if u.dtype not in _SUFFIX:
        raise TypeError(f"unsupported storage dtype {u.dtype}; expected one "
                        f"of {list(_SUFFIX)}")
    if u.dim() != 1 or u.numel() % 3:
        raise ValueError(f"u must be a flat (3 * n_nodes,) dof vector, got "
                         f"{tuple(u.shape)}")
    if ke.dim() != 3 or ke.shape[1] != ke.shape[2] \
            or ke.shape[1] not in _ELEMENT_WIDTHS:
        raise ValueError(f"ke must be (n_elem, d, d) with d in "
                         f"{_ELEMENT_WIDTHS}, got {tuple(ke.shape)}")
    E, d = ke.shape[:2]
    for name, t, dtype, shape in (
            ("u", u, u.dtype, u.shape), ("ke", ke, u.dtype, ke.shape),
            ("conn", conn, torch.int64, (E, d // 3)),
            ("scale", scale, u.dtype, (E,)), ("mask", mask, u.dtype, u.shape)):
        if t is not None:
            _check_cuda(name, t, dtype, shape, u.device)
    return E, d


def element_apply(u, conn, ke, scale=None, mask=None):
    """Per-corner rows of s_e ke_e (m u)_e for every element e, and one zero
    row after them: (n_elem * d / 3 + 1, 3), the padded input of the
    operator's fixed-order incidence-table sum.

    u: flat (3 * n_nodes,) dof vector; conn: (n_elem, d / 3) int64 node
    numbers (dof = 3 * node + component); ke: (n_elem, d, d) with d = 12
    (tet4) or 24 (hex8); scale (n_elem,) and the dof mask m (like u) may be
    None.  u, ke, scale and mask share the storage dtype; bfloat16 computes
    in float32.  CPU tensors take `element_apply_plain`; CUDA tensors
    launch the kernel."""
    E, d = _check_elements(u, conn, ke, scale, mask)
    if u.device.type == "cpu":
        return element_apply_plain(u, conn, ke, scale, mask)
    if u.device.type != "cuda":
        raise ValueError(f"no element_apply for device {u.device}")
    if ke.data_ptr() % 16:
        raise ValueError("ke must start on a 16-byte boundary")
    lib = build_element_kernels()
    out = u.new_empty((E * d // 3 + 1, 3))
    opt = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"element_apply_{_SUFFIX[u.dtype]}")(
            u.data_ptr(), conn.data_ptr(), ke.data_ptr(), opt(scale),
            opt(mask), out.data_ptr(), E, d, stream)
    _raise_on(err, "element_apply")
    count(_COUNTER["element_apply"][u.dtype])
    return out


def stencil_apply_plain(C, mask, x, r=None, apply=apply_stencil):
    """`stencil_apply` in plain tensor code on any device: mask, unmasked
    apply, mask, then r minus it where r is given.  A field in another dtype
    than the stencil's is applied in the stencil's: m x cast to it, the
    result cast back.  `apply(C, u)` is the unmasked apply (the sharded
    hierarchy passes its form with a halo)."""
    if C.dtype != x.dtype:
        y = mask * apply(C, (mask * x).to(C.dtype)).to(x.dtype)
    else:
        y = mask * apply(C, mask * x)
    return y if r is None else r - y


def _check_stencil(C, mask, x, r):
    """Checks `stencil_apply`'s arguments; returns the node counts."""
    for name, t in (("C", C), ("x", x)):
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name} has unsupported dtype {t.dtype}; "
                            f"expected one of {list(_SUFFIX)}")
    if x.dim() != 4 or x.shape[-1] != 3 or min(x.shape[:3]) < 1:
        raise ValueError(f"x must be a (nnx, nny, nnz, 3) node field, got "
                         f"{tuple(x.shape)}")
    nodes = tuple(x.shape[:3])
    _check_cuda("C", C, C.dtype, (3, 3, 3, 3, 3, *nodes), x.device)
    for name, t in (("x", x), ("mask", mask), ("r", r)):
        if t is not None:
            _check_cuda(name, t, x.dtype, x.shape, x.device)
    return nodes


def stencil_apply(C, mask, x, r=None):
    """The masked stencil apply of the multigrid's coarse levels,
    M C (M x), or r - M C (M x) where r is given: (nnx, nny, nnz, 3) in x's
    dtype.

    C: the level's stencil (3, 3, 3, 3, 3, nnx, nny, nnz) (ops/stencil.py);
    mask (the 0/1 dof mask), x and r: node fields (nnx, nny, nnz, 3) in one
    dtype, which may differ from C's: the apply then runs in C's dtype, as
    `stencil_apply_plain` states.  All contiguous, on one device.  CPU
    tensors take `stencil_apply_plain`; CUDA tensors launch the kernel."""
    nnx, nny, nnz = _check_stencil(C, mask, x, r)
    if x.device.type == "cpu":
        return stencil_apply_plain(C, mask, x, r)
    if x.device.type != "cuda":
        raise ValueError(f"no stencil_apply for device {x.device}")
    lib = build_stencil_kernels()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"stencil_apply_{_SUFFIX[C.dtype]}_"
                           f"{_SUFFIX[x.dtype]}")(
            C.data_ptr(), mask.data_ptr(), x.data_ptr(),
            None if r is None else r.data_ptr(), out.data_ptr(),
            nnx, nny, nnz, stream)
    _raise_on(err, "stencil_apply")
    count(_COUNTER["stencil_apply"][C.dtype])
    return out
