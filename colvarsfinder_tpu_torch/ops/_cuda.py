"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library is built at first use from the package's own sources, into
``build/cvf_torch_kernels/`` beside the package; its file name carries a
hash of the sources and flags, so an edited source is rebuilt.
:func:`build_all` starts one ``nvcc`` per source, all at once;
:func:`build_copies` builds copies of a source with textual edits (phase
ablations, exactness checks against a variant).

Each wrapper counts its launches on the host, in the recorder's counter
``cvf.kernel.launches.<name>`` (:func:`..logging_utils.count`);
:func:`launch_counts` and :data:`LAUNCHES` read them. A CUDA graph replay
runs no Python: :mod:`..graphs` carries the counts a graph holds into its
replays.

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
from collections.abc import MutableMapping
from pathlib import Path

from ..logging_utils import count, counters

__all__ = [
    "COUNTER",
    "KERNELS",
    "LAUNCHES",
    "build_all",
    "build_copies",
    "check",
    "launch_counts",
    "library",
    "reset_launch_counts",
    "stream_handle",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cvf_torch_kernels"
SOURCES = ("kabsch", "fused_eigen", "pair_distances", "kabsch_exact")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: flags a library takes beyond :data:`NVCC_FLAGS`: K6 matches PyTorch's
#: kernels bit for bit, one rounded operation at a time, so no product of
#: it may be contracted into an FMA
EXTRA_FLAGS = {"kabsch_exact": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point, per library
_SIGNATURES = {
    "kabsch": {
        "cvf_kabsch_qcp": (_P, _P, _I, _I, _P),
        "cvf_kabsch_qcp_occupancy": (_I, _P),
        "cvf_fused_align": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "cvf_fused_align_occupancy": (_I, _P),
    },
    "fused_eigen": {
        "cvf_stats_fwd": (_P,) * 8 + (_P, _I, _I, _I, _I, _I, _P),
        "cvf_stats_bwd": (_P,) * 9 + (_P, _I, _I, _I, _I, _I, _P),
        "cvf_stats_fwd_occupancy": (_I, _I, _P),
        "cvf_stats_bwd_occupancy": (_I, _I, _P),
    },
    "pair_distances": {
        "cvf_pair_distances": (_P, _P, _P, _I, _I, _I, _I, _P),
        "cvf_pair_distances_max_atoms": (_I, _P),
    },
    "kabsch_exact": {
        "cvf_kabsch_exact": (_P, _P, _I, _I, _P),
    },
}

#: the kernel wrappers, each counting its launches in the recorder's
#: counter ``COUNTER + name``, where it launches its kernel and nowhere else
KERNELS = ("kabsch_qcp", "fused_align", "stats_fwd", "stats_bwd",
           "pair_distances", "kabsch_exact")
COUNTER = "cvf.kernel.launches."


class _Launches(MutableMapping):
    """The launch counters of :data:`KERNELS` as a mapping by wrapper name:
    reading one reads the recorder's counter, setting one sets it."""

    def __getitem__(self, name: str) -> int:
        if name not in KERNELS:
            raise KeyError(name)
        return counters().get(COUNTER + name, 0)

    def __setitem__(self, name: str, value: int) -> None:
        count(COUNTER + name, value - self[name])

    def __delitem__(self, name: str) -> None:
        raise TypeError("the launch counters are fixed")

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)


#: launches of each kernel wrapper since the last reset
LAUNCHES = _Launches()

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    now = counters()
    return {name: now.get(COUNTER + name, 0) for name in KERNELS}


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


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source, or return None if its library exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-I", str(CSRC), "-o", str(tmp),
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


def _load(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _LIBS[name] = _load(_lib_path(name), name)
    return lib


def build_copies(name: str, edits: dict, directory) -> dict:
    """Libraries built from copies of ``csrc/<name>.cu`` with textual edits.

    ``edits`` maps a copy's name to a list of ``(file, old, new)``
    replacements in ``<name>.cu`` or in a header of ``csrc/``, each ``old``
    found exactly once (an empty list: the source as it is). Each copy is
    written to its own subdirectory of ``directory``, where its edited
    headers shadow those of ``csrc/``; one ``nvcc`` per copy, all started
    together. Returns ``{copy name: loaded library}``.
    """
    procs = {}
    try:
        for copy, changes in edits.items():
            d = Path(directory) / copy.replace(" ", "_")
            d.mkdir(parents=True, exist_ok=True)
            files = {f"{name}.cu": (CSRC / f"{name}.cu").read_text()}
            for fname, old, new in changes:
                text = files.get(fname) or (CSRC / fname).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(
                        f"{copy}: text to replace not found once in {fname}")
                files[fname] = text.replace(old, new)
            for fname, text in files.items():
                (d / fname).write_text(text)
            so = d / f"{name}.so"
            procs[copy] = (so, subprocess.Popen(
                [_nvcc(), *_flags(name), "-I", str(CSRC), "-o", str(so),
                 str(d / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for copy, (so, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for copy {copy!r}:\n{out}")
            libs[copy] = _load(so, name)
        return libs
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def stream_handle() -> int:
    """Handle of PyTorch's current CUDA stream, for the C entry points."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
