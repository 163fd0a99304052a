"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries go to ``build/kernels/`` at the repository root, named by a hash
of their sources and flags, so an edited source rebuilds and an unchanged
one is reused. ``build_all`` starts one ``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: ptxas's report (registers, shared memory, spills) of the last build, by name.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str, out: Path) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no library yet, one ``nvcc`` each, all started together. Returns the
    seconds each build took (0.0 for a library that was already there)."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    seconds = {n: 0.0 for n in names}
    with _LOCK:
        started = {}
        for n in names:
            out = _library_path(n)
            if not out.exists():
                started[n] = (*_start_build(n, out), out, time.perf_counter())
        for n, (proc, tmp, out, t0) in started.items():
            _finish_build(n, proc, tmp, out)
            seconds[n] = time.perf_counter() - t0
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if need be.
    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    returns an ``int`` CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = _library_path(name)
        if not out.exists():
            proc, tmp = _start_build(name, out)
            _finish_build(name, proc, tmp, out)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.tdt_error_string.argtypes = [ctypes.c_int]
        lib.tdt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.tdt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer (None → NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
