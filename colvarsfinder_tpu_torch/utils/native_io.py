"""ctypes bindings to the native IO library (``native/fastio.cpp``).

Copied from ``colvarsfinder_tpu/utils/native_io.py``: the hot host-side
paths of the data pipeline (memory-mapped trajectory text parsing, DCD
frame gathering, XTC scan, decode and encode), with a transparent fallback
to the pure-Python codecs when the library cannot be built. The Python
codecs are the reference the native ones are held against.

The library is compiled with ``g++`` at first use into
``build/cvf_torch_native/`` under a name that carries a hash of the source
and the flags, as the port's ``deploy_native.py`` builds
``native/cveval.cpp``; the build writes a temporary file and renames it,
so a concurrent process never loads a half-written library. The JAX
package builds the same source into ``native/build/libcvfio.so``: the two
never share a file, so a rebuild by one cannot yank the other's mapped
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "fastio.cpp"
BUILD_DIR = _ROOT / "build" / "cvf_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-Wall", "-fPIC", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _build() -> Optional[Path]:
    """Compile ``native/fastio.cpp`` unless its library exists; None when
    the source or ``g++`` is missing or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return None
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"fastio-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        _bind(lib)
        _LIB = lib
    return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures."""
    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    signatures = {
        "traj_txt_dims": ([ctypes.c_char_p, i64p, i64p], ctypes.c_int),
        "traj_txt_read": ([ctypes.c_char_p, f64p, i64, i64], i64),
        "dcd_decode": ([ctypes.c_char_p, i64, i64, i64, ctypes.c_int,
                        f32p], i64),
        "xtc_scan": ([ctypes.c_char_p, i64p, i64p], ctypes.c_int),
        "xtc_decode": ([ctypes.c_char_p, f32p, f32p, i64, i64], i64),
        # the precision is a double: quantization uses the full-precision
        # factor, so the output stays bit-identical with the Python codec
        # for precisions f32 cannot hold exactly (e.g. 100.3)
        "xtc_encode": ([ctypes.c_char_p, f32p, i64, i64, ctypes.c_double,
                        f64p, ctypes.c_double, ctypes.c_double, i64], i64),
    }
    for name, (argtypes, restype) in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype


def available() -> bool:
    return _load() is not None


def load_time_series(filename: str) -> Optional[np.ndarray]:
    """Parse a whitespace numeric text file into [n, cols] float64, or None
    if the native library is unavailable / parsing fails."""
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.traj_txt_dims(filename.encode(), ctypes.byref(rows),
                           ctypes.byref(cols))
    if rc != 0 or rows.value == 0 or cols.value == 0:
        return None
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    got = lib.traj_txt_read(filename.encode(), out, rows.value, cols.value)
    if got != rows.value:
        return None
    return out


def scan_xtc(filename: str):
    """(n_frames, n_atoms) of an XTC file by walking frame headers without
    decoding, via the native library; None to fall back to Python."""
    lib = _load()
    if lib is None:
        return None
    n_frames = ctypes.c_int64()
    n_atoms = ctypes.c_int64()
    rc = lib.xtc_scan(
        filename.encode(), ctypes.byref(n_frames), ctypes.byref(n_atoms)
    )
    if rc != 0:
        return None
    # a frame can never hold more atoms than the file has bytes — guards
    # giant allocations from corrupt headers (fall back to the Python
    # codec, which raises a descriptive error)
    if n_frames.value > 0 and (
        n_atoms.value <= 0
        or n_frames.value * n_atoms.value * 12
        > 64 * os.path.getsize(filename)
    ):
        return None
    return n_frames.value, n_atoms.value


def decode_xtc(filename: str, coords_out: np.ndarray | None = None):
    """Bulk-decode an XTC file into ([n, atoms, 3] float32, times [n]) via
    the native library, or None to fall back to the Python codec.

    ``coords_out``: optional preallocated [n, atoms, 3] float32
    C-contiguous buffer the decoder writes into directly — pass a
    ``np.memmap`` (``numpy.lib.format.open_memmap``) to decode datasets
    larger than host RAM straight to disk (the input file is mmap'd by
    the native side, so neither side is fully resident).
    """
    lib = _load()
    scanned = scan_xtc(filename)
    if lib is None or scanned is None:
        return None
    n_frames, n_atoms = scanned
    if n_frames == 0:
        return None
    if coords_out is None:
        coords = np.empty((n_frames, n_atoms, 3), dtype=np.float32)
    else:
        assert coords_out.shape == (n_frames, n_atoms, 3), (
            f"coords_out shape {coords_out.shape} != "
            f"{(n_frames, n_atoms, 3)} from the file scan"
        )
        assert coords_out.dtype == np.float32 and coords_out.flags[
            "C_CONTIGUOUS"
        ], "coords_out must be C-contiguous float32"
        coords = coords_out
    times = np.empty(n_frames, dtype=np.float32)
    got = lib.xtc_decode(
        filename.encode(), coords, times, n_frames, n_atoms
    )
    if got != n_frames:
        return None
    return coords, times.astype(np.float64)


def encode_xtc(
    filename: str,
    coords: np.ndarray,
    precision: float,
    box_mat: np.ndarray,
    t0_ps: float,
    dt_ps: float,
    step_interval: int,
) -> bool:
    """Bulk-encode frames [n, atoms, 3] float32 to an XTC file via the
    native library. Returns False to fall back to the Python codec.

    Raises ValueError on coordinate overflow at the given precision (the
    same condition the Python codec rejects).
    """
    lib = _load()
    if lib is None:
        return False
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    n_frames, n_atoms = coords.shape[0], coords.shape[1]
    box9 = np.ascontiguousarray(box_mat, dtype=np.float64).reshape(9)
    got = lib.xtc_encode(
        filename.encode(), coords, n_frames, n_atoms,
        float(precision), box9, float(t0_ps), float(dt_ps),
        int(step_interval),
    )
    if got == -5:
        raise ValueError(
            "coordinate magnitude too large for XTC quantization; "
            "reduce the precision"
        )
    return got == n_frames


def decode_dcd_frames(
    filename: str,
    frame0_offset: int,
    n_atoms: int,
    n_frames: int,
    has_unitcell: bool,
) -> Optional[np.ndarray]:
    """Decode DCD coordinate records into [n_frames, n_atoms, 3] float32."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n_frames, n_atoms, 3), dtype=np.float32)
    got = lib.dcd_decode(
        filename.encode(), frame0_offset, n_atoms, n_frames,
        1 if has_unitcell else 0, out,
    )
    if got < 0:
        return None
    return out[:got]
