"""Builds the port's CUDA sources with ``nvcc`` at first use and loads
them through ``ctypes`` (plain C entry points, no PyTorch headers, so a
source builds in seconds).

Each source under ``kernels/*/csrc/`` becomes one shared library in
``build/repro_torch/`` at the root of the checkout, named after a digest
of its sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build` starts one ``nvcc`` per
library, all at once.  Nothing here runs when the module is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a run
resets it with :func:`reset_launches` and reads it afterwards to show
which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: library name -> (source relative to kernels/, extra nvcc flags).
#: The sampler's decode must not contract ``1 + 8x`` into an FMA: the
#: float estimate would then differ from XLA-CPU's before its fix-up.
SOURCES: Dict[str, tuple] = {
    "sampler": ("sampler/csrc/sampler.cu", ["-fmad=false"]),
    "hist": ("hist/csrc/hist.cu", []),
}

LAUNCHES: Dict[str, int] = {"chunk_draw": 0, "chunk_decode": 0, "hist": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src, flags = SOURCES[name]
    csrc = (_KERNELS / src).parent
    h = hashlib.sha256(" ".join(_NVCC_FLAGS + flags).encode())
    for f in sorted(csrc.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named libraries (all by default) that are not built
    yet, one ``nvcc`` each, all started together.  Returns each
    compiled library's ``nvcc`` output (``-Xptxas -v``: registers and
    shared memory per kernel); raises if any compile fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        src, flags = SOURCES[name]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *_NVCC_FLAGS, *flags, "-o", str(tmp), str(_KERNELS / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.  Every entry
    point in ``signatures`` gets its ``argtypes`` and returns the
    ``cudaError_t`` of its launch as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def check_arg(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: what a kernel reads through a raw pointer."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_arg(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
