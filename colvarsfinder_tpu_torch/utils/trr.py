r"""Native TRR trajectory codec (GROMACS full-precision format).

Copied from ``colvarsfinder_tpu/utils/trr.py``: host-side numpy,
the imports adapted to the port.

TRR is GROMACS' lossless trajectory container — the format users reach
for when XTC's fixed-point compression is not acceptable (exact restarts,
velocities, forces). The reference consumes trajectories through
MDAnalysis, which reads TRR via libxdrfile
(reference: colvarsfinder/utils.py:96-130); this module implements the
format natively so :class:`colvarsfinder_tpu_torch.utils.io.Universe` accepts
``.trr`` alongside ``.xtc``/``.dcd``.

Frame layout (all fields XDR big-endian; the classic ``trnio`` layout of
libxdrfile's ``do_trnheader``/``do_htrn``):

====================  =======================================================
int32                 magic (1993)
int32                 13 — length of the version string + NUL
int32, 12 bytes       XDR string "GMX_trn_file"
int32[7]              ir_size, e_size, box_size, vir_size, pres_size,
                      top_size, sym_size (all 0 in trajectory frames except
                      box_size)
int32[3]              x_size, v_size, f_size (bytes; 0 = array absent)
int32                 natoms
int32, int32          step, nre
real, real            t (ps), lambda
real[9]               box vectors (row-major 3x3, nm; if box_size > 0)
real[9]               vir, pres (if their sizes > 0)
real[3*natoms]        x, then v, then f (each if its size > 0)
====================  =======================================================

``real`` is float32 or float64 per frame, inferred from
``x_size / (3 * natoms)`` (falling back to v/f/box sizes when x is absent)
— exactly libxdrfile's ``nFloatSize`` logic. The header's t/lambda use the
same precision as the arrays.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["read_trr", "write_trr", "scan_trr", "TRRFrames", "TRR_MAGIC"]

TRR_MAGIC = 1993
_VERSION = b"GMX_trn_file"


@dataclass
class TRRFrames:
    """Full decoded contents of a TRR file (arrays are float32 or float64
    matching the file precision; absent quantities are None)."""

    coords: Optional[np.ndarray]        # [n, natoms, 3] nm
    velocities: Optional[np.ndarray]    # [n, natoms, 3] nm/ps
    forces: Optional[np.ndarray]        # [n, natoms, 3] kJ/mol/nm
    boxes: Optional[np.ndarray]         # [n, 3, 3] nm
    times: np.ndarray                   # [n] ps
    steps: np.ndarray                   # [n]
    lambdas: np.ndarray                 # [n]

    @property
    def n_frames(self) -> int:
        return len(self.times)


def _read_frame_header(buf, off: int):
    (magic,) = struct.unpack_from(">i", buf, off)
    if magic != TRR_MAGIC:
        raise ValueError(f"bad TRR magic {magic} at offset {off}")
    slen, vlen = struct.unpack_from(">ii", buf, off + 4)
    if slen != len(_VERSION) + 1 or vlen != len(_VERSION):
        raise ValueError(
            f"unexpected TRR version-string lengths ({slen}, {vlen}) at "
            f"offset {off}"
        )
    voff = off + 12
    vpad = (vlen + 3) & ~3
    if bytes(buf[voff:voff + vlen]) != _VERSION:
        raise ValueError(f"unexpected TRR version string at offset {off}")
    off = voff + vpad
    (ir_size, e_size, box_size, vir_size, pres_size, top_size, sym_size,
     x_size, v_size, f_size, natoms, step, nre) = struct.unpack_from(
        ">13i", buf, off
    )
    off += 52
    if natoms <= 0:
        raise ValueError(f"implausible TRR atom count {natoms}")
    # infer the frame's float width (libxdrfile nFloatSize)
    width = 0
    for size, per in ((x_size, 3 * natoms), (v_size, 3 * natoms),
                      (f_size, 3 * natoms), (box_size, 9)):
        if size:
            width = size // per
            break
    if width not in (4, 8):
        raise ValueError(
            f"cannot infer TRR precision at offset {off} "
            f"(x/v/f/box sizes {x_size}/{v_size}/{f_size}/{box_size})"
        )
    fmt = ">d" if width == 8 else ">f"
    t = struct.unpack_from(fmt, buf, off)[0]
    lam = struct.unpack_from(fmt, buf, off + width)[0]
    off += 2 * width
    return off, dict(
        box_size=box_size, vir_size=vir_size, pres_size=pres_size,
        x_size=x_size, v_size=v_size, f_size=f_size, natoms=natoms,
        step=step, nre=nre, t=t, lam=lam, width=width,
        ir_size=ir_size, e_size=e_size, top_size=top_size,
        sym_size=sym_size,
    )


def _array_bytes(h) -> int:
    n = 0
    for k in ("box_size", "vir_size", "pres_size", "x_size", "v_size",
              "f_size"):
        n += h[k]
    return n


def scan_trr(filename: str):
    """``(n_frames, n_atoms)`` by walking frame headers without decoding
    the coordinate payloads."""
    with open(filename, "rb") as f:
        buf = memoryview(f.read())
    n_frames, n_atoms, off = 0, 0, 0
    while off + 12 <= len(buf):
        off, h = _read_frame_header(buf, off)
        off += _array_bytes(h)
        if off > len(buf):
            raise ValueError(f"truncated TRR frame {n_frames} in {filename}")
        if n_frames == 0:
            n_atoms = h["natoms"]
        elif h["natoms"] != n_atoms:
            raise ValueError(
                f"atom count changes mid-file: {n_atoms} -> {h['natoms']}"
            )
        n_frames += 1
    return n_frames, n_atoms


def read_trr(filename: str, full: bool = False):
    """Read a TRR trajectory.

    Returns ``(coords [n, natoms, 3] float32 nm, dt_ps, times_ps)`` —
    the same contract as :func:`~colvarsfinder_tpu_torch.utils.xtc.read_xtc` —
    or, with ``full=True``, a :class:`TRRFrames` with velocities, forces,
    boxes, steps, and lambdas in the file's own precision.
    """
    with open(filename, "rb") as f:
        buf = memoryview(f.read())
    xs: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    fs: List[np.ndarray] = []
    boxes: List[np.ndarray] = []
    times: List[float] = []
    steps: List[int] = []
    lams: List[float] = []
    off = 0
    while off + 12 <= len(buf):
        off, h = _read_frame_header(buf, off)
        width = h["width"]
        rdt = np.dtype(">f8" if width == 8 else ">f4")
        natoms = h["natoms"]

        def take(nbytes, count):
            nonlocal off
            if nbytes == 0:
                return None
            if nbytes != count * width:
                raise ValueError(
                    f"array size {nbytes} != {count} reals of width "
                    f"{width} at offset {off}"
                )
            if off + nbytes > len(buf):
                raise ValueError(
                    f"truncated TRR frame {len(times)} in {filename}"
                )
            arr = np.frombuffer(buf, dtype=rdt, count=count, offset=off)
            off += nbytes
            return arr

        box = take(h["box_size"], 9)
        take(h["vir_size"], 9)
        take(h["pres_size"], 9)
        x = take(h["x_size"], 3 * natoms)
        v = take(h["v_size"], 3 * natoms)
        frc = take(h["f_size"], 3 * natoms)
        if off > len(buf):
            raise ValueError(
                f"truncated TRR frame {len(times)} in {filename}"
            )
        xs.append(None if x is None else x.reshape(natoms, 3))
        vs.append(None if v is None else v.reshape(natoms, 3))
        fs.append(None if frc is None else frc.reshape(natoms, 3))
        boxes.append(None if box is None else box.reshape(3, 3))
        times.append(h["t"])
        steps.append(h["step"])
        lams.append(h["lam"])

    def stack(parts):
        if not parts or any(p is None for p in parts):
            return None
        native = np.dtype(parts[0].dtype.kind + str(parts[0].dtype.itemsize))
        return np.stack(parts).astype(native)

    times_a = np.asarray(times, dtype=np.float64)
    if full:
        return TRRFrames(
            coords=stack(xs), velocities=stack(vs), forces=stack(fs),
            boxes=stack(boxes), times=times_a,
            steps=np.asarray(steps, dtype=np.int64),
            lambdas=np.asarray(lams, dtype=np.float64),
        )
    coords = stack(xs)
    if coords is None:
        if times:
            raise ValueError(f"{filename} contains no coordinate frames")
        coords = np.zeros((0, 0, 3), np.float32)
    dt_ps = float(times_a[1] - times_a[0]) if len(times_a) > 1 else 0.0
    return coords.astype(np.float32), dt_ps, times_a


def write_trr(
    filename: str,
    coords: np.ndarray,
    dt_ps: float = 1.0,
    velocities: Optional[np.ndarray] = None,
    forces: Optional[np.ndarray] = None,
    box: Optional[np.ndarray] = None,
    t0_ps: float = 0.0,
    step_interval: int = 1,
    double: bool = False,
) -> None:
    """Write frames [n_frames, n_atoms, 3] (nm) as a GROMACS TRR file.

    ``velocities``/``forces`` (same shape) are written when given; ``box``
    may be [3] (diagonal lengths, nm) or [3, 3]. ``double=True`` writes
    float64 reals (GROMACS double-precision convention); the default is
    float32.
    """
    coords = np.asarray(coords)
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(
            f"coords must be [n_frames, n_atoms, 3]; got {coords.shape}"
        )
    n_frames, natoms = coords.shape[:2]
    width = 8 if double else 4
    rdt = np.dtype(">f8" if double else ">f4")
    ffmt = ">d" if double else ">f"

    if box is None:
        box_mat = np.zeros((3, 3))
        lo = np.min(coords, axis=(0, 1)) if coords.size else np.zeros(3)
        hi = np.max(coords, axis=(0, 1)) if coords.size else np.ones(3)
        np.fill_diagonal(box_mat, np.maximum(hi - lo, 1.0))
    else:
        box = np.asarray(box, dtype=np.float64)
        box_mat = np.diag(box) if box.ndim == 1 else box
        if box_mat.shape != (3, 3):
            raise ValueError(f"box must be [3] or [3, 3]; got {box.shape}")

    for name, arr in (("velocities", velocities), ("forces", forces)):
        if arr is not None and np.asarray(arr).shape != coords.shape:
            raise ValueError(
                f"{name} shape {np.asarray(arr).shape} != coords shape "
                f"{coords.shape}"
            )

    vlen = len(_VERSION)
    vpad = ((vlen + 3) & ~3) - vlen
    x_size = 3 * natoms * width
    v_size = x_size if velocities is not None else 0
    f_size = x_size if forces is not None else 0
    with open(filename, "wb") as f:
        for i in range(n_frames):
            f.write(struct.pack(">iii", TRR_MAGIC, vlen + 1, vlen))
            f.write(_VERSION + b"\x00" * vpad)
            f.write(struct.pack(
                ">13i",
                0, 0, 9 * width, 0, 0, 0, 0,      # ir e box vir pres top sym
                x_size, v_size, f_size, natoms,
                i * step_interval, 0,
            ))
            f.write(struct.pack(ffmt, t0_ps + i * dt_ps))
            f.write(struct.pack(ffmt, 0.0))  # lambda
            f.write(np.ascontiguousarray(box_mat, dtype=rdt).tobytes())
            f.write(np.ascontiguousarray(coords[i], dtype=rdt).tobytes())
            if velocities is not None:
                f.write(
                    np.ascontiguousarray(velocities[i], dtype=rdt).tobytes()
                )
            if forces is not None:
                f.write(
                    np.ascontiguousarray(forces[i], dtype=rdt).tobytes()
                )
