"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
is compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/`` at the repository root, on first use.
The file name carries a hash of the source and the flags, so an edited
source rebuilds and a stale library is never loaded.  ``build_all``
starts one ``nvcc`` per source together and waits for all of them.

Libraries are loaded with ``ctypes``.  A wrapper calls its C entry
through an ``Entry``, the launch path: the argument types are set once,
when the entry is first bound (``c_void_p`` for every pointer and the
stream, so plain Python ints pass), the bound function is kept, so no
lock is taken per call, and the stream is the raw handle of PyTorch's
current stream (``stream``), read without building a ``Stream`` object.
Every C entry returns ``cudaGetLastError()`` after its launch, so that a
refused launch raises in the wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc on a machine with the card")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns name → library path."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])     # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


_ARGTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "q": ctypes.c_longlong, "f": ctypes.c_float}


class Entry:
    """The C entry ``name`` of ``csrc/<lib>.cu``, bound on its first call.

    ``signature`` gives one letter per argument: ``p`` a pointer or the
    stream (pass ``data_ptr()`` or ``stream(...)``, plain ints), ``i`` an
    int, ``q`` a 64-bit int, ``f`` a float.  A call returns nothing and
    raises ``RuntimeError`` on a non-zero ``cudaError_t``."""

    __slots__ = ("lib", "name", "signature", "fn")

    def __init__(self, lib: str, name: str, signature: str):
        self.lib, self.name, self.signature = lib, name, signature
        self.fn = None

    def bind(self):
        fn = getattr(load(self.lib), self.name)
        fn.argtypes = [_ARGTYPES[c] for c in self.signature]
        fn.restype = ctypes.c_int
        self.fn = fn
        return fn

    def __call__(self, *args) -> None:
        err = (self.fn or self.bind())(*args)
        if err:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")


def stream(device_index: int) -> int:
    """The raw handle of the current CUDA stream of a device, as an int:
    the capture stream inside ``torch.cuda.graph``.  PyTorch's own
    accessor (``at::cuda::getCurrentCUDAStream``), without the ``Stream``
    object that ``torch.cuda.current_stream`` builds."""
    return torch._C._cuda_getCurrentRawStream(device_index)


__all__ = ["build_all", "load", "Entry", "stream", "sources", "BUILD_DIR",
           "CSRC", "NVCC_FLAGS"]
