"""Builds the port's CUDA sources with ``nvcc`` at first use and loads
them through ``ctypes`` (plain C entry points, no PyTorch headers, so a
source builds in seconds).

Each source under ``kernels/*/csrc/`` becomes one shared library in
``build/repro_torch/`` at the root of the checkout, named after a digest
of its sources, the headers it may include and its flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build` starts one ``nvcc`` per
library, all at once, each under a file lock, so processes that start
together compile a library once.  Nothing here runs when the module is
imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a run
resets it with :func:`reset_launches` and reads it afterwards to show
which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import fcntl
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
#: The geometric and Delaunay libraries fuse exactly where XLA-CPU does,
#: with explicit ``fma``, and nowhere else.
SOURCES: Dict[str, tuple] = {
    "sampler": ("sampler/csrc/sampler.cu", ["-fmad=false"]),
    "collision": ("sampler/csrc/collision.cu", []),
    "hist": ("hist/csrc/hist.cu", []),
    "pairmask": ("pairmask/csrc/pairmask.cu", ["-fmad=false"]),
    "geom": ("geom/csrc/geom.cu", ["-fmad=false"]),
    "delaunay": ("delaunay/csrc/delaunay.cu", ["-fmad=false"]),
    "wedges": ("wedges/csrc/wedges.cu", []),
}

LAUNCHES: Dict[str, int] = {"chunk_sample": 0, "chunk_decode": 0, "hist": 0,
                            "pair_mask": 0, "hyp_edges": 0, "pair_edges": 0, "cell_points": 0,
                            "triangulate": 0, "circumspheres": 0,
                            "chunk_rmat": 0, "chunk_ba": 0, "close_wedges": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU, and a CUDA device without an index is the current one
    (a rank of a world makes its own current).  Raises when CUDA is
    asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
    # the source's own directory, and every header a source may include
    files = set(csrc.iterdir()) | set(_KERNELS.glob("*/csrc/*.cuh"))
    for f in sorted(files):
        h.update(str(f.relative_to(_KERNELS)).encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _locked(out: Path, wait: bool):
    """The open lock file of library ``out``, held exclusively (``fcntl``);
    ``None`` when ``wait`` is false and another process holds it."""
    f = open(out.with_name(out.name + ".lock"), "w")
    try:
        fcntl.flock(f, fcntl.LOCK_EX | (0 if wait else fcntl.LOCK_NB))
    except BlockingIOError:
        f.close()
        return None
    return f


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named libraries (all by default) that are not built
    yet, one ``nvcc`` each, all started together.  Returns each
    compiled library's ``nvcc`` output (``-Xptxas -v``: registers and
    shared memory per kernel); raises if any compile fails.

    Each library is built under a file lock next to it, so processes that
    start together (the ranks of a world, test workers) run ``nvcc`` once
    a library: a library another process is building is waited for, after
    this process has started its own compiles, and built here only if
    that process did not finish it."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, failed = {}, []

    def compile_all(todo) -> list:
        procs = []
        for name, lock in todo:
            out = library_path(name)
            if out.exists():        # built by the lock's previous holder
                lock.close()
                continue
            src, flags = SOURCES[name]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *_NVCC_FLAGS, *flags, "-o", str(tmp), str(_KERNELS / src)]
            procs.append((name, lock, tmp, out,
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
        return procs

    def finish(procs) -> None:
        for name, lock, tmp, out, proc in procs:
            with lock:
                logs[name] = proc.communicate()[0]
                if proc.returncode:
                    failed.append(f"{name}:\n{logs[name]}")
                else:
                    os.replace(tmp, out)

    mine, busy = [], []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        lock = _locked(out, wait=False)
        if lock is None:
            busy.append(name)
        else:
            mine.append((name, lock))
    finish(compile_all(mine))
    finish(compile_all([(name, _locked(library_path(name), wait=True)) for name in busy]))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.  Every entry
    point in ``signatures`` gets its ``argtypes`` and returns the
    ``cudaError_t`` of its launch as an int.  A loaded library is
    returned without taking the lock."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
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
    if t.dtype != dtype or t.shape != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_arg(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a CUDA tensor's
    device, which has an index), as the raw pointer a launch takes: the
    getter PyTorch's own generated kernels use, since building a
    ``torch.cuda.Stream`` costs microseconds on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def query(device: torch.device, entry, *args) -> int:
    """``entry(*args)`` with ``device`` (indexed) made the current device
    for the call: every entry point reads the SM count and occupancy, and
    sets kernel attributes, on the current device.  Returns its
    ``cudaError_t``."""
    with torch.cuda.device(device.index):
        return entry(*args)


def current_index() -> int:
    """The calling thread's current CUDA device index: the getter behind
    ``torch.cuda.current_device`` without its lazy-init check (a launch
    has a CUDA tensor, so CUDA is initialised)."""
    return torch._C._cuda_getDevice()


def launch(kernel: str, device: torch.device, entry, *args) -> None:
    """Launch ``entry(*args, stream)`` on ``device``'s current stream with
    ``device`` made current for the call (an entry point launches on the
    current device, so a tensor on another card than the current one
    would otherwise run on the wrong card or fail), and raise if the
    launch fails.  Where ``device`` is already current, as on one card,
    no device guard is entered.  Every kernel binding launches through
    here; counting the launch in :data:`LAUNCHES` is the binding's."""
    if device.index == current_index():
        check(entry(*args, stream_arg(device)), kernel)
        return
    with torch.cuda.device(device.index):
        check(entry(*args, stream_arg(device)), kernel)
