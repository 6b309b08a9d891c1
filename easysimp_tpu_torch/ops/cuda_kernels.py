"""The voxel operator's two hand-written CUDA kernels, their plain PyTorch
versions, their launch counters and their build.

Counterpart of easysimp_tpu/ops/pallas_kernels.py:

  voxel_matvec    replaces `_kernel` (make_pallas_matvec,
                  easysimp_tpu/ops/pallas_kernels.py:183-342): the fused SIMP
                  stiffness matvec K(rho) u on a hex8 voxel grid.
  voxel_energies  replaces `_energies_kernel` (make_pallas_energies,
                  easysimp_tpu/ops/pallas_kernels.py:345-430): the per-element
                  quadratic u_e^T ke u_e.

Both kernels are CUDA C++ for sm_90a in `csrc/voxel_kernels.cu`; the source
says what bounds each on an H100 and what its design does about it.  For
float32 and bfloat16 storage they run the element product on the tensor
cores in 3xTF32 (`tf32_round` below states that arithmetic in PyTorch); for
float64 they are simple kernels on the FP64 CUDA cores.  They are built at
first use with `nvcc` into a shared library with a plain C interface, under
`_build/` keyed by a hash of the sources, and loaded with ctypes.

Each wrapper dispatches on the device of its tensors: a CPU tensor takes the
plain version (the reference XLA path's gather -> (N,24)@(24,24) ->
scatter-add, written in PyTorch), a CUDA tensor launches the kernel or
raises.  There is no fallback: a missing `nvcc`, a failed build or a refused
launch raises.  `<wrapper>.launches` counts kernel launches and nothing else.

bf16 storage computes in fp32, as the Pallas kernels do: the wrappers take
`ke` in the compute dtype (float64 for float64 storage, float32 otherwise).
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

from .elements import HEX_CORNERS

__all__ = [
    "compute_dtype",
    "gather_element_dofs",
    "scatter_element_dofs",
    "voxel_matvec",
    "voxel_matvec_plain",
    "voxel_energies",
    "voxel_energies_plain",
    "voxel_matvec_simple_f32",
    "tf32_round",
    "build_kernels",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}

_lib = None          # the loaded shared library (built at first CUDA use)
build_info: dict = {}  # path, seconds and compiler output of the last build


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


def voxel_energies_plain(u, ke):
    """u_e^T ke u_e per element, (nx, ny, nz), computed in ke's dtype."""
    ue = gather_element_dofs(u).to(ke.dtype)
    q = (ue.reshape(-1, 24) @ ke).reshape(ue.shape)
    return (ue * q).sum(dim=-1).to(u.dtype)


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


def build_kernels():
    """Build (if needed) and load the kernels' shared library.

    The library goes to `_build/voxel_kernels_<hash>.so`, keyed by the
    sources, so an edited source is rebuilt and an unchanged one reused.
    Raises on any failure."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = _BUILD / f"voxel_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp),
               *[str(s) for s in sources if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr = ctypes.c_void_p
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"voxel_matvec_{sfx}")
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"voxel_energies_{sfx}")
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    lib.voxel_matvec_simple_f32.argtypes = lib.voxel_matvec_f32.argtypes
    lib.voxel_matvec_simple_f32.restype = ctypes.c_int
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      log=log)
    _lib = lib
    return lib


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
    voxel_matvec.launches += 1
    return out


voxel_matvec.launches = 0


def voxel_matvec_simple_f32(u, scale, ke):
    """The first, simple float32 matvec kernel (CUDA cores, one thread per
    node), kept only as a yardstick for `voxel_matvec`: `chip_smoke.py`
    times the two in the same run.  CUDA float32 tensors only."""
    if u.device.type != "cuda" or u.dtype != torch.float32:
        raise ValueError("voxel_matvec_simple_f32 takes CUDA float32 "
                         f"tensors, got {u.dtype} on {u.device}")
    out = _launch_matvec("voxel_matvec_simple_f32", u, scale, ke)
    voxel_matvec_simple_f32.launches += 1
    return out


voxel_matvec_simple_f32.launches = 0


def voxel_energies(u, ke):
    """u_e^T ke u_e per element, (nx, ny, nz), in u's storage dtype.

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
    voxel_energies.launches += 1
    return out


voxel_energies.launches = 0
