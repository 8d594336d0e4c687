r"""Native XTC trajectory codec (GROMACS compressed format).

Copied from ``colvarsfinder_tpu/utils/xtc.py``: host-side numpy,
the imports adapted to the port.

The reference's dipeptide workflow consumes an ``.xtc`` trajectory through
MDAnalysis (reference: colvarsfinder/utils.py:96-130;
examples/dipeptide/main.ipynb cell 2). MDAnalysis is not a dependency of
this framework, so the format is implemented natively: the XDR container
plus the ``3dfcoord`` lossy integer compression scheme (coordinates
quantized to ``round(x * precision)``, stored as variable-radix packed
integers with run-length-coded small inter-atom deltas — the classic
public-domain algorithm from libxdrf used by every GROMACS-compatible
reader).

Python implementation is the portable reference; a C++ fast path for bulk
decoding lives in ``native/fastio.cpp`` and is used automatically when
built (see :mod:`colvarsfinder_tpu_torch.utils.native_io`).

Layout of one frame (all fields XDR big-endian):

====================  =======================================================
int32                 magic (1995)
int32                 natoms
int32                 step
float32               time (ps)
float32[9]            box vectors (row-major 3x3, nm)
int32                 natoms (again; written in both branches)
--- if natoms <= 9 ---
float32[3*natoms]     plain coordinates
--- else -------------
float32               precision
int32[3], int32[3]    minint / maxint of the quantized coordinates
int32                 smallidx (initial small-delta magnitude class)
int32                 nbytes of compressed payload
bytes                 payload, zero-padded to a 4-byte boundary
====================  =======================================================
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["read_xtc", "read_xtc_memmap", "scan_xtc", "write_xtc", "XTC_MAGIC"]

XTC_MAGIC = 1995

# magnitude classes ~ 2^(k/3): the radix used for small-delta encoding
_MAGICINTS = (
    0, 0, 0, 0, 0, 0, 0, 0, 0,
    8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645,
    812, 1024, 1290, 1625, 2048, 2580, 3250, 4096, 5060, 6501,
    8192, 10321, 13003, 16384, 20642, 26007, 32768, 41285, 52015, 65536,
    82570, 104031, 131072, 165140, 208063, 262144, 330280, 416127,
    524287, 660561, 832255, 1048576, 1321122, 1664510, 2097152,
    2642245, 3329021, 4194304, 5284491, 6658042, 8388607, 10568983,
    13316085, 16777216,
)
_FIRSTIDX = 9
_LASTIDX = len(_MAGICINTS)
_MAXABS = 2**31 - 2


def _magic(idx: int) -> int:
    return _MAGICINTS[min(idx, _LASTIDX - 1)]


def _bits_for(size: int) -> int:
    """Number of bits needed to hold values in [0, size)."""
    n, bits = 1, 0
    while size >= n and bits < 32:
        bits += 1
        n <<= 1
    return bits


def _bits_for_triple(sizes) -> int:
    """Bits needed for three values packed in mixed radix (sizes as bases)."""
    prod = int(sizes[0]) * int(sizes[1]) * int(sizes[2])
    n_bytes = max(1, (prod.bit_length() + 7) // 8)
    top = prod >> (8 * (n_bytes - 1))
    return 8 * (n_bytes - 1) + _bits_for(top)


# ---------------------------------------------------------------------------
# bit stream
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over a bytes payload."""

    __slots__ = ("data", "pos", "nheld", "held")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0       # next byte index
        self.nheld = 0     # bits currently held
        self.held = 0      # right-aligned held bits

    def read(self, nbits: int) -> int:
        while self.nheld < nbits:
            self.held = (self.held << 8) | self.data[self.pos]
            self.pos += 1
            self.nheld += 8
        self.nheld -= nbits
        out = (self.held >> self.nheld) & ((1 << nbits) - 1)
        self.held &= (1 << self.nheld) - 1
        return out

    def read_packed(self, nbits: int) -> int:
        """Read an ``nbits``-wide packed integer stored as little-endian
        bytes (full 8-bit chunks first, the top partial chunk last)."""
        val = 0
        shift = 0
        while nbits > 8:
            val |= self.read(8) << shift
            shift += 8
            nbits -= 8
        if nbits > 0:
            val |= self.read(nbits) << shift
        return val

    def read_triple(self, nbits: int, sizes) -> Tuple[int, int, int]:
        """Read three mixed-radix packed values (bases ``sizes``)."""
        v = self.read_packed(nbits)
        s1, s2 = int(sizes[1]), int(sizes[2])
        c = v % s2
        v //= s2
        b = v % s1
        a = v // s1
        return a, b, c


class _BitWriter:
    """MSB-first bit writer."""

    __slots__ = ("out", "nheld", "held")

    def __init__(self):
        self.out = bytearray()
        self.nheld = 0
        self.held = 0

    def write(self, nbits: int, value: int):
        self.held = (self.held << nbits) | (value & ((1 << nbits) - 1))
        self.nheld += nbits
        while self.nheld >= 8:
            self.nheld -= 8
            self.out.append((self.held >> self.nheld) & 0xFF)
        self.held &= (1 << self.nheld) - 1

    def write_packed(self, nbits: int, value: int):
        """Write ``value`` into an ``nbits``-wide field as little-endian
        bytes: full 8-bit chunks first, the top (possibly partial) chunk
        last, zero-padded to ``nbits``."""
        nb = max(1, (int(value).bit_length() + 7) // 8)
        if nbits >= nb * 8:
            for j in range(nb):
                self.write(8, (value >> (8 * j)) & 0xFF)
            self.write(nbits - nb * 8, 0)
        else:
            for j in range(nb - 1):
                self.write(8, (value >> (8 * j)) & 0xFF)
            self.write(nbits - (nb - 1) * 8, value >> (8 * (nb - 1)))

    def write_triple(self, nbits: int, sizes, abc):
        packed = (
            (int(abc[0]) * int(sizes[1]) + int(abc[1])) * int(sizes[2])
            + int(abc[2])
        )
        self.write_packed(nbits, packed)

    def getvalue(self) -> bytes:
        if self.nheld:
            tail = (self.held << (8 - self.nheld)) & 0xFF
            return bytes(self.out) + bytes([tail])
        return bytes(self.out)


# ---------------------------------------------------------------------------
# one-frame codec
# ---------------------------------------------------------------------------

def _decode_frame_coords(buf: memoryview, off: int, natoms: int):
    """Decode one compressed coordinate block.

    Returns (coords [natoms, 3] float32, precision, new offset).
    """
    lsize, precision = struct.unpack_from(">if", buf, off)
    off += 8
    if lsize != natoms:
        raise ValueError(f"coordinate block atom count {lsize} != {natoms}")
    minint = struct.unpack_from(">3i", buf, off)
    maxint = struct.unpack_from(">3i", buf, off + 12)
    smallidx = struct.unpack_from(">i", buf, off + 24)[0]
    (nbytes,) = struct.unpack_from(">i", buf, off + 28)
    off += 32
    payload = bytes(buf[off : off + nbytes])
    off += (nbytes + 3) & ~3  # payload is padded to 4 bytes

    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if min(sizeint) <= 0:
        raise ValueError(
            f"corrupt XTC frame: maxint {maxint} < minint {minint}"
        )
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_bits_for(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _bits_for_triple(sizeint)

    smallnum = _magic(smallidx) // 2
    smaller = _magic(max(_FIRSTIDX, smallidx - 1)) // 2
    sizesmall = [_magic(smallidx)] * 3

    reader = _BitReader(payload)
    coords = np.empty((natoms, 3), dtype=np.int32)
    run = 0
    i = 0
    out = 0
    while i < natoms:
        if bitsize == 0:
            this = [reader.read(bitsizeint[d]) for d in range(3)]
        else:
            this = list(reader.read_triple(bitsize, sizeint))
        for d in range(3):
            this[d] += minint[d]
        prev = list(this)
        i += 1

        is_smaller = 0
        if reader.read(1):
            run = reader.read(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                d3 = reader.read_triple(smallidx, sizesmall)
                this = [d3[d] + prev[d] - smallnum for d in range(3)]
                i += 1
                if k == 0:
                    # the encoder stored these two atoms swapped (water
                    # heuristic); emit in swapped order and keep the
                    # delta-decoded atom as the base for the next delta
                    this, prev = prev, this
                    coords[out] = prev
                    out += 1
                else:
                    prev = this
                coords[out] = this
                out += 1
        else:
            coords[out] = this
            out += 1

        smallidx += is_smaller
        if is_smaller < 0:
            smallnum = smaller
            smaller = (
                _magic(smallidx - 1) // 2 if smallidx > _FIRSTIDX else 0
            )
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = _magic(smallidx) // 2
        sizesmall = [_magic(smallidx)] * 3
    # single vectorized f32 dequantization (bit-identical to the C++ path:
    # int -> f32 conversion, then f32 multiply by 1/precision)
    inv = np.float32(1.0) / np.float32(precision)
    return coords.astype(np.float32) * inv, precision, off


def _encode_frame_coords(coords: np.ndarray, precision: float) -> bytes:
    """Encode one frame's coordinates as a compressed block."""
    natoms = coords.shape[0]
    q = np.asarray(coords, dtype=np.float64) * precision
    ints = np.where(q >= 0, np.floor(q + 0.5), np.ceil(q - 0.5)).astype(
        np.int64
    )
    if np.abs(ints).max(initial=0) >= _MAXABS:
        raise ValueError(
            "coordinate magnitude too large for XTC quantization; "
            "reduce the precision"
        )
    ints = ints.astype(np.int32)
    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    sizeint = [int(maxint[d]) - int(minint[d]) + 1 for d in range(3)]
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_bits_for(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _bits_for_triple(sizeint)

    # smallest inter-atom step sets the starting magnitude class
    diffs = np.abs(np.diff(ints.astype(np.int64), axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if len(diffs) else 2**31 - 1
    smallidx = _FIRSTIDX
    while smallidx < _LASTIDX - 1 and _MAGICINTS[smallidx] < mindiff:
        smallidx += 1

    smallidx0 = smallidx  # header stores the starting magnitude class
    maxidx = min(_LASTIDX - 1, smallidx + 8)
    minidx = maxidx - 8
    larger = _magic(maxidx) // 2
    smallnum = _magic(smallidx) // 2
    smaller = _magic(max(_FIRSTIDX, smallidx - 1)) // 2
    sizesmall = [_magic(smallidx)] * 3

    w = _BitWriter()
    ints_list = ints.tolist()
    prevrun = -1
    prev = None
    i = 0
    while i < natoms:
        this = list(ints_list[i])
        # decide whether to shrink/grow the small-delta class
        if (
            smallidx < maxidx
            and i >= 1
            and all(abs(this[d] - prev[d]) < larger for d in range(3))
        ):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0
        # swap this atom with the next when they are close (water heuristic)
        is_small = i + 1 < natoms and all(
            abs(this[d] - ints_list[i + 1][d]) < smallnum for d in range(3)
        )
        if is_small:
            this, ints_list[i + 1] = list(ints_list[i + 1]), this

        if bitsize == 0:
            for d in range(3):
                w.write(bitsizeint[d], this[d] - int(minint[d]))
        else:
            w.write_triple(
                bitsize, sizeint, [this[d] - int(minint[d]) for d in range(3)]
            )
        prev = this
        i += 1

        deltas: List[int] = []
        if not is_small and is_smaller == -1:
            is_smaller = 0
        while is_small and len(deltas) < 8 * 3:
            this = list(ints_list[i])
            if is_smaller == -1 and sum(
                (this[d] - prev[d]) ** 2 for d in range(3)
            ) >= smaller * smaller:
                is_smaller = 0
            deltas.extend(this[d] - prev[d] + smallnum for d in range(3))
            prev = this
            i += 1
            is_small = i < natoms and all(
                abs(ints_list[i][d] - prev[d]) < smallnum for d in range(3)
            )
        run = len(deltas)
        if run != prevrun or is_smaller != 0:
            prevrun = run
            w.write(1, 1)
            w.write(5, run + is_smaller + 1)
        else:
            w.write(1, 0)
        for k in range(0, run, 3):
            w.write_triple(smallidx, sizesmall, deltas[k : k + 3])
        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = _magic(smallidx - 1) // 2
            else:
                smaller = smallnum
                smallnum = _magic(smallidx) // 2
            sizesmall = [_magic(smallidx)] * 3

    payload = w.getvalue()
    head = struct.pack(">if", natoms, precision)
    head += struct.pack(">3i", *[int(v) for v in minint])
    head += struct.pack(">3i", *[int(v) for v in maxint])
    head += struct.pack(">i", smallidx0)
    head += struct.pack(">i", len(payload))
    pad = (-len(payload)) % 4
    return head + payload + b"\x00" * pad


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------

def read_xtc(filename: str):
    """Read an XTC trajectory.

    Returns ``(coords [n_frames, n_atoms, 3] float32 in nm, dt_ps,
    times_ps [n_frames])`` where ``dt_ps`` is the spacing of the first two
    frame timestamps (0.0 for single-frame files).

    Uses the C++ bulk decoder from ``native/fastio.cpp`` when available,
    falling back to the pure-Python codec.
    """
    from . import native_io

    native = native_io.decode_xtc(filename)
    if native is not None:
        coords, times = native
    else:
        with open(filename, "rb") as f:
            buf = memoryview(f.read())
        frames = []
        times_l = []
        off = 0
        while off + 16 <= len(buf):
            magic, natoms, _step, t = struct.unpack_from(">iiif", buf, off)
            if magic != XTC_MAGIC:
                raise ValueError(
                    f"bad XTC magic {magic} at offset {off} in {filename}"
                )
            # a frame can never hold more atoms than bytes remaining in
            # the file — guards giant allocations from corrupt headers
            if natoms < 0 or natoms > len(buf):
                raise ValueError(
                    f"implausible atom count {natoms} at offset {off} in "
                    f"{filename}"
                )
            off += 16 + 36  # header + 3x3 box
            try:
                if natoms <= 9:
                    # the format repeats natoms (lsize) before the plain
                    # floats, exactly as in the compressed branch
                    (lsize,) = struct.unpack_from(">i", buf, off)
                    if lsize != natoms:
                        raise ValueError(
                            f"coordinate block atom count {lsize} != "
                            f"{natoms}"
                        )
                    off += 4
                    xyz = np.frombuffer(
                        buf, dtype=">f4", count=3 * natoms, offset=off
                    ).reshape(natoms, 3)
                    off += 12 * natoms
                    frames.append(xyz.astype(np.float32))
                else:
                    xyz, _prec, off = _decode_frame_coords(buf, off, natoms)
                    frames.append(xyz)
            except (IndexError, struct.error, ValueError) as e:
                raise ValueError(
                    f"truncated or corrupt XTC frame {len(frames)} in "
                    f"{filename}: {e}"
                ) from e
            times_l.append(t)
        coords = (
            np.stack(frames) if frames else np.zeros((0, 0, 3), np.float32)
        )
        times = np.asarray(times_l, dtype=np.float64)
    dt_ps = float(times[1] - times[0]) if len(times) > 1 else 0.0
    return coords, dt_ps, times


def _skip_frame(buf, off: int):
    """Advance past one frame without decoding (mirror of the native
    ``xtc_skip_frame``); returns ``(next_off, natoms, time_ps)``."""
    magic, natoms, _step, t = struct.unpack_from(">iiif", buf, off)
    if magic != XTC_MAGIC:
        raise ValueError(f"bad XTC magic {magic} at offset {off}")
    off += 16 + 36  # header + 3x3 box
    if natoms <= 9:
        off += 4 + natoms * 12  # repeated lsize + plain floats
    else:
        # coordinate block: lsize, precision, minint[3], maxint[3],
        # smallidx (36 bytes), then the compressed byte count
        (nbytes,) = struct.unpack_from(">i", buf, off + 36)
        if nbytes < 0:
            raise ValueError(f"negative block size at offset {off}")
        off += 40 + ((nbytes + 3) & ~3)
    if off > len(buf):
        raise ValueError("truncated XTC frame")
    return off, natoms, t


def scan_xtc(filename: str):
    """``(n_frames, n_atoms)`` of an XTC file by walking the frame headers
    without decoding any coordinates. Native-accelerated; the Python walk
    memory-maps the file, so arbitrarily large files scan cheaply."""
    from . import native_io

    scanned = native_io.scan_xtc(filename)
    if scanned is not None:
        return scanned
    import mmap as _mmap

    with open(filename, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return 0, 0
        buf = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        try:
            n_frames, n_atoms, off = 0, 0, 0
            while off + 16 <= size:
                off, na, _t = _skip_frame(buf, off)
                if n_frames == 0:
                    n_atoms = na
                elif na != n_atoms:
                    raise ValueError(
                        f"atom count changes mid-file: {n_atoms} -> {na}"
                    )
                n_frames += 1
            return n_frames, n_atoms
        finally:
            buf.close()


def read_xtc_memmap(filename: str, out_path: str):
    """Decode an XTC trajectory DIRECTLY into an on-disk ``.npy`` memmap —
    the data path for trajectories whose decoded coordinates exceed host
    RAM (the tasks' ``streaming=True`` layout then trains straight off
    the memmap; see docs/performance.md).

    Both sides stay out of RAM: the input file is memory-mapped for
    decoding, and the decoder writes into the ``open_memmap`` output
    pages, which the OS writes back as needed.

    Returns ``(coords_memmap [n_frames, n_atoms, 3] float32 nm, dt_ps,
    times_ps)``.
    """
    from numpy.lib.format import open_memmap

    from . import native_io

    n_frames, n_atoms = scan_xtc(filename)
    coords = open_memmap(
        out_path, mode="w+", dtype=np.float32,
        shape=(int(n_frames), int(n_atoms), 3),
    )
    if n_frames == 0:
        return coords, 0.0, np.zeros(0, dtype=np.float64)

    native = native_io.decode_xtc(filename, coords_out=coords)
    if native is not None:
        _, times = native
    else:
        import mmap as _mmap

        times_l = []
        with open(filename, "rb") as f:
            mbuf = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            try:
                buf = memoryview(mbuf)
                off = 0
                for fidx in range(n_frames):
                    _magic_v, natoms, _step, t = struct.unpack_from(
                        ">iiif", buf, off
                    )
                    off += 16 + 36
                    if natoms <= 9:
                        (lsize,) = struct.unpack_from(">i", buf, off)
                        if lsize != natoms:
                            raise ValueError(
                                f"coordinate block atom count {lsize} != "
                                f"{natoms}"
                            )
                        off += 4
                        xyz = np.frombuffer(
                            buf, dtype=">f4", count=3 * natoms, offset=off
                        ).reshape(natoms, 3)
                        off += 12 * natoms
                        coords[fidx] = xyz.astype(np.float32)
                    else:
                        xyz, _prec, off = _decode_frame_coords(
                            buf, off, natoms
                        )
                        coords[fidx] = xyz
                    times_l.append(t)
                del buf
            finally:
                mbuf.close()
        times = np.asarray(times_l, dtype=np.float64)
    coords.flush()
    dt_ps = float(times[1] - times[0]) if len(times) > 1 else 0.0
    return coords, dt_ps, times


def write_xtc(
    filename: str,
    coords: np.ndarray,
    dt_ps: float = 1.0,
    precision: float = 1000.0,
    box: Optional[np.ndarray] = None,
    step_interval: int = 1,
    t0_ps: float = 0.0,
):
    """Write frames [n_frames, n_atoms, 3] (nm) as a compressed XTC file.

    ``precision`` is the quantization factor (1000.0 = the GROMACS default,
    i.e. coordinates stored to 0.001 nm).
    """
    coords = np.asarray(coords, dtype=np.float32)
    n_frames, n_atoms, _ = coords.shape
    if box is None:
        if n_frames == 0:
            box_mat = np.eye(3)
        else:
            ext = coords.max(axis=(0, 1)) - coords.min(axis=(0, 1)) + 1.0
            box_mat = np.diag(ext.astype(np.float64))
    else:
        box_mat = np.asarray(box, dtype=np.float64)
        if box_mat.ndim == 1:
            box_mat = np.diag(box_mat)

    # C++ bulk encoder (bit-identical with the loop below; ~100x faster on
    # long trajectories)
    from . import native_io

    if n_frames > 0 and native_io.encode_xtc(
        filename, coords, precision, box_mat, t0_ps, dt_ps, step_interval
    ):
        return

    with open(filename, "wb") as f:
        for j in range(n_frames):
            f.write(
                struct.pack(
                    ">iiif",
                    XTC_MAGIC,
                    n_atoms,
                    j * step_interval,
                    t0_ps + j * dt_ps,
                )
            )
            f.write(struct.pack(">9f", *box_mat.reshape(-1)))
            if n_atoms <= 9:
                # lsize is written unconditionally before the coordinate
                # payload (libxdrf convention), followed by plain floats
                f.write(struct.pack(">i", n_atoms))
                f.write(
                    np.ascontiguousarray(coords[j], dtype=">f4").tobytes()
                )
            else:
                f.write(_encode_frame_coords(coords[j], precision))
