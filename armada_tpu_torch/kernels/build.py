"""Build the CUDA sources of ../csrc into one shared library with a plain C
interface and load it with ctypes.

The build runs at first use, on the machine with the card: one `nvcc -c` per
source, all started together, then one link.  Output goes to
armada_tpu_torch/_build/, keyed by a hash of the sources and flags, so an
unchanged tree reuses its library.  Flags: sm_90a, C++17, -O3, -fmad=false
(no contraction: the f32 association of every ordering value is written out
in the sources), and no fast math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("fair_shares.cu", "round.cu", "round_wide.cu", "round_cluster.cu", "compact.cu",
           "slab.cu", "verify.cu", "explain.cu", "lanes.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(SRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libarmada_kernels-{_digest()}.so"
    if lib.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (src + ".o")
        cmd = [nvcc, *FLAGS, "-c", str(SRC_DIR / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    failed = []
    for src, obj, proc in procs:
        out, err = proc.communicate()
        log.append(f"== {src} (rc {proc.returncode})\n{out}{err}")
        if proc.returncode != 0:
            failed.append(src)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(log)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.armada_fair_shares.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.armada_fair_shares.restype = ci
        lib.armada_fair_shares_form.argtypes = [ci]
        lib.armada_fair_shares_form.restype = ci
        lib.armada_round_prologue.argtypes = [vp, vp]
        lib.armada_round_prologue.restype = ci
        lib.armada_round_main.argtypes = [vp, vp, vp, ci, vp]
        lib.armada_round_main.restype = ci
        lib.armada_round_sharded_main.argtypes = [vp, ci, vp, vp, ci, vp]
        lib.armada_round_sharded_main.restype = ci
        lib.armada_round_cluster_max.argtypes = [vp, ci]
        lib.armada_round_cluster_max.restype = ci
        lib.armada_round_wide_need.argtypes = [ci, ci, vp]
        lib.armada_round_wide_need.restype = None
        lib.armada_round_args_size.argtypes = []
        lib.armada_round_args_size.restype = ci
        lib.armada_compact.argtypes = [vp, vp]
        lib.armada_compact.restype = ci
        lib.armada_compact_args_size.argtypes = []
        lib.armada_compact_args_size.restype = ci
        lib.armada_compact_ws_words.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        lib.armada_compact_ws_words.restype = ctypes.c_longlong
        lib.armada_slab_apply.argtypes = [vp, vp]
        lib.armada_slab_apply.restype = ci
        lib.armada_slab_ws_bytes.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        lib.armada_slab_ws_bytes.restype = ctypes.c_longlong
        lib.armada_verify.argtypes = [vp, vp]
        lib.armada_verify.restype = ci
        lib.armada_verify_ws_bytes.argtypes = [ctypes.c_longlong] * 4
        lib.armada_verify_ws_bytes.restype = ctypes.c_longlong
        lib.armada_explain.argtypes = [vp, vp]
        lib.armada_explain.restype = ci
        lib.armada_explain_len.argtypes = [vp]
        lib.armada_explain_len.restype = ctypes.c_longlong
        lib.armada_fadd_cycles.argtypes = [vp, ci, vp]
        lib.armada_fadd_cycles.restype = ci
        lib.armada_lanes_copy.argtypes = [vp, ci, vp]
        lib.armada_lanes_copy.restype = ci
        for name in ("armada_slab_call_size", "armada_verify_args_size",
                     "armada_explain_args_size", "armada_lanes_desc_size",
                     "armada_lanes_tile_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ci
        _LIB = lib
    return _LIB


def stream_handle() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        kind = "cudaError_t" if rc > 0 else "argument check"
        raise RuntimeError(f"{what}: launch failed ({kind} {rc})")


def require_cuda(t, name: str, dtype, ndim: int | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `ndim`)."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def placed(tensors, dev) -> bool:
    """All of `tensors` contiguous and on `dev`, in one pass each and
    without names: a wrapper's fast check of its inputs, before the checks
    one at a time that name the first failing input."""
    import torch

    try:
        return (set(map(torch.Tensor.get_device, tensors))
                <= {dev.index if dev.type == "cuda" else -1}
                and all(map(torch.Tensor.is_contiguous, tensors)))
    except TypeError:  # not a tensor
        return False
