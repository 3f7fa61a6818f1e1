"""Build and load the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` (a float kernel and its quantized twin,
two instances of one template; the int8 KV write; or the token draw)
compiles with
``nvcc`` into its own shared library with a plain C interface, loaded
with ``ctypes`` — no PyTorch
headers, so a build takes seconds, not minutes.  Libraries land in
``build/kernels/`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads from the cache.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module, and
this host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("monarch", "bdmm", "paged", "kv_write", "sample")
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")  # where the toolkit puts it
# -Xptxas -v: each kernel's registers and spills, kept in BUILD_LOG
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes understood by the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else (the CPU path never counts)
LAUNCHES = {"monarch_fused": 0, "bdmm": 0, "paged_attention_span": 0,
            "monarch_fused_q": 0, "bdmm_q": 0, "paged_attention_span_q": 0,
            "paged_attention_span_sharded": 0,
            "paged_attention_span_sharded_q": 0, "quantize_kv_write": 0,
            "sample_tokens": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
# source -> the compiler's output of its last build in this process
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and CUDA_NVCC.exists():
        path = str(CUDA_NVCC)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel; returns the seconds each
    build took (0.0 for a cache hit).  Raises with the compiler's output
    when a build fails."""
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp, path)
    errors = []
    for n, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        BUILD_LOG[n] = out.decode()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out.decode()}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str, fn: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with ``fn``'s C signature
    declared (built first when missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# PyTorch's raw accessor of the current stream's handle, resolved once: a
# private name (CUDA builds of torch 2.x have it), so a torch without it
# takes the public ``torch.cuda.current_stream`` instead, which returns the
# same handle but builds a Stream object on every call -- more host time
# than a decode-sized kernel takes on the card.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def dtype_code(t: torch.Tensor, what: str) -> int:
    return dtype_code_of(t.dtype, what)


def dtype_code_of(dtype: torch.dtype, what: str) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"{what}: unsupported dtype {dtype} "
                        f"(float32 or bfloat16)") from None


__all__ = ["build_all", "library", "launches", "reset_launches", "LAUNCHES",
           "SOURCES", "BUILD_LOG", "build_dir", "check"]
