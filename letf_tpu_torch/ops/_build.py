"""Build and bind the port's CUDA kernels.

Each ``letf_tpu_torch/csrc/*.cu`` source compiles with its own nvcc
process, all started together, and the objects link into ONE shared library
with a plain C interface, at first use, into ``build/letf_tpu_torch/`` at
the repository root (listed in .gitignore). The library file name carries
a hash of the sources and flags, so an edited source rebuilds. It is loaded
with ctypes; every C entry returns ``cudaGetLastError()`` after its launch
and ``check`` raises on a non-zero code.

Flags: sm_90a, -O3, and ``-fmad=false`` so that ``a*b + c`` is not
contracted to an FMA: the kernels then round like their plain PyTorch
versions op by op, and borderline strategy compares flip less between the
two. No ``--use_fast_math``: the fast intrinsics would move the Box-Muller
normals by far more than ulps. The sources of ``FMAD_SOURCES`` keep nvcc's
default ``-fmad=true``, as torch's own kernels are built: they call
libdevice functions that must give torch's bits (float64 ``pow``
contracts its own products) and write their arithmetic with the ``_rn``
intrinsics, which are never contracted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "letf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false")
FMAD_SOURCES = ("draws.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures of the entries (csrc/*.cu); the last argument is the stream.
SIGNATURES = {
    "letf_joint": [_P, _P, _I, _P, _P, _P, _U, _U, _I, _I,
                   _P, _P, _P, _P, _P, _P],
    "letf_window": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    "letf_compose_strategies": [_P, _P, _P, _P, _P, _U, _U, _P, _P, _P,
                                _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "letf_compose": [_P, _P, _P, _P, _U, _U, _P, _P, _P, _P, _P, _P, _I, _I,
                     _P, _P, _P, _P, _P, _P],
    "letf_merge": [_I, _P, _P, _P, _I, _U, _I, _I, _P, _P, _P],
    "letf_wash": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "letf_strategies": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "letf_gbm": [_U, _U, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P],
    "letf_draw_normal": [_P, _L, _L, _L, _I, _P, _P],
    "letf_draw_gamma": [_P, _L, _L, _D, _I, _I, _P, _P],
    "letf_draw_t": [_P, _L, _L, _D, _P, _I, _P, _P],
    "letf_emit_days": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "letf_kernel_info": [_I, _P],
    "letf_joint_math_check": [_P, _P, _I, _P, _P],
}
# The kernels letf_kernel_info reports on, in its index order (csrc/info.cu),
# and the fields of each report (common.cuh::letf_fill_info).
KERNEL_INFO = ("joint", "window", "compose_strategies", "strategies",
               "strategies_fused", "compose", "gbm", "merge", "wash",
               "draws_normal", "draws_gamma", "draws_t", "emit_days")
INFO_FIELDS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
               "threads", "blocks_per_sm", "warps_per_sm")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def source_flags(name: str) -> tuple:
    """nvcc's flags for source ``name``: NVCC_FLAGS, with -fmad=true for
    the FMAD_SOURCES."""
    if name not in FMAD_SOURCES:
        return NVCC_FLAGS
    return tuple("-fmad=true" if f == "-fmad=false" else f
                 for f in NVCC_FLAGS)


def library_path() -> Path:
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + FMAD_SOURCES).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libletf_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources if the hashed library is missing; returns its
    path. ``verbose`` adds ``-Xptxas -v`` (registers, spills) to the
    printed compiler output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    cmds = [[nvcc, *source_flags(s.name),
             *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(o),
             str(s)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{tag}.so")
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(link)
    if verbose or failed:
        print("\n".join(x for x in logs if x))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: "
                           + "; ".join(" ".join(c) for c in failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.letf_error_string.argtypes = [ctypes.c_int]
        lib.letf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info() -> dict:
    """{kernel: {field: int}} for every kernel of the library at its launch
    shape (INFO_FIELDS): registers and local (spill) bytes a thread, shared
    memory, and the blocks and warps the card keeps resident on an SM."""
    lib = library()
    out = {}
    for i, name in enumerate(KERNEL_INFO):
        buf = (ctypes.c_int * len(INFO_FIELDS))()
        check(lib.letf_kernel_info(i, ctypes.cast(buf, ctypes.c_void_p)),
              f"letf_kernel_info({name})")
        out[name] = dict(zip(INFO_FIELDS, buf))
    return out


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().letf_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, device, **tensors) -> None:
    """Wrapper-side checks: every tensor on ``device``, contiguous, of the
    expected dtype (given as (tensor, dtype) pairs)."""
    for arg, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
