"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library is built at first use from the package's own sources, into
``build/cvf_torch_kernels/`` beside the package; its file name carries a
hash of the sources and flags, so an edited source is rebuilt.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc``.
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

__all__ = [
    "LAUNCHES",
    "build_all",
    "check",
    "launch_counts",
    "library",
    "reset_launch_counts",
    "stream_handle",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cvf_torch_kernels"
SOURCES = ("kabsch", "fused_eigen")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point, per library
_SIGNATURES = {
    "kabsch": {
        "cvf_kabsch_qcp": (_P, _P, _I, _P),
        "cvf_fused_align": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
    "fused_eigen": {
        "cvf_stats_fwd": (_P,) * 7 + (_P, _I, _I, _I, _I, _I, _P),
        "cvf_stats_bwd": (_P,) * 8 + (_P, _I, _I, _I, _I, _I, _P),
    },
}

#: launches of each kernel wrapper since the last reset; a wrapper adds one
#: where it launches its kernel and nowhere else
LAUNCHES = {"kabsch_qcp": 0, "fused_align": 0, "stats_fwd": 0, "stats_bwd": 0}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for base in filter(None, (home, "/usr/local/cuda")):
        cand = Path(base) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME and /usr/local/cuda); the "
        "CUDA kernels are built from csrc/ at first use"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source, or return None if its library exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stdout}\n{stderr}"
        )
    os.replace(tmp, out)


def build_all() -> float:
    """Build every kernel library that is missing, one ``nvcc`` per source
    started together; returns the wall time in seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        started = [(name, _start(name)) for name in SOURCES]
        try:
            for name, st in started:
                _finish(name, st)
        finally:
            for _, st in started:
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def stream_handle() -> int:
    """Handle of PyTorch's current CUDA stream, for the C entry points."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
