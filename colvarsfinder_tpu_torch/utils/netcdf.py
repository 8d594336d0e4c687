r"""Native Amber NetCDF trajectory codec.

Copied from ``colvarsfinder_tpu/utils/netcdf.py``: host-side numpy,
the imports adapted to the port.

Amber's trajectory container is a NetCDF *classic-format* file following
the `AMBER NetCDF trajectory convention
<https://ambermd.org/netcdf/nctraj.xhtml>`_ (``Conventions = "AMBER"``),
the third of the big-three MD trajectory ecosystems next to GROMACS
(``.xtc``/``.trr``) and CHARMM/NAMD/OpenMM (``.dcd``). The reference
consumes trajectories through MDAnalysis, which reads ``.nc`` via
netCDF4/scipy (reference: colvarsfinder/utils.py:96-130); this module
implements both the container format (NetCDF classic, CDF-1/CDF-2) and
the Amber convention natively in numpy so
:class:`colvarsfinder_tpu_torch.utils.io.Universe` accepts ``.nc`` alongside
``.xtc``/``.trr``/``.dcd`` with zero extra dependencies.

NetCDF classic container layout (all values big-endian; the on-disk
grammar of the NetCDF classic format specification):

====================  =====================================================
4 bytes               magic ``CDF`` + version byte (1 = CDF-1 with 32-bit
                      offsets, 2 = CDF-2 with 64-bit offsets)
int32                 numrecs — number of records along the UNLIMITED dim
dim_list              tag ``NC_DIMENSION`` (0x0A) + count, then per dim:
                      name (int32 length + bytes, zero-padded to 4) and
                      int32 size (0 marks the UNLIMITED/record dimension)
gatt_list             tag ``NC_ATTRIBUTE`` (0x0C) + count, then per
                      attribute: name, int32 nc_type, int32 nelems,
                      values zero-padded to 4 bytes
var_list              tag ``NC_VARIABLE`` (0x0B) + count, then per
                      variable: name, int32 rank, int32 dimids[rank],
                      vatt_list, int32 nc_type, int32 vsize, offset
                      ``begin`` (int32 for CDF-1, int64 for CDF-2)
data                  fixed-size variables at their ``begin`` offsets,
                      then ``numrecs`` interleaved records — one
                      per-record slab per record variable, in varid
                      order, each slab padded to a 4-byte boundary
====================  =====================================================

``vsize`` is the per-record (for record variables) or total (for fixed
variables) byte size rounded up to a multiple of 4. Absent dim/att/var
lists are encoded as two zero int32s. nc_types: 1 byte, 2 char, 3 short,
4 int, 5 float, 6 double.

The Amber convention on top: dimensions ``frame`` (unlimited),
``spatial`` = 3, ``atom``; variables ``time(frame)`` in picoseconds and
``coordinates(frame, atom, spatial)`` in angstroms, optionally
``velocities`` and ``cell_lengths``/``cell_angles``. Like the DCD codec
(io.py), coordinates are returned exactly as stored — by convention
angstroms, NOT converted to the .gro/.xtc nanometer convention — and a
``scale_factor`` attribute (used by Amber for velocity units) is applied
when present.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "read_netcdf",
    "read_netcdf_full",
    "read_netcdf_memmap",
    "write_netcdf",
    "scan_netcdf",
    "NetCDFFrames",
]

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

# nc_type -> (numpy dtype, element size)
_NC_DTYPES = {
    1: (np.dtype(">i1"), 1),  # NC_BYTE
    2: (np.dtype("S1"), 1),   # NC_CHAR
    3: (np.dtype(">i2"), 2),  # NC_SHORT
    4: (np.dtype(">i4"), 4),  # NC_INT
    5: (np.dtype(">f4"), 4),  # NC_FLOAT
    6: (np.dtype(">f8"), 8),  # NC_DOUBLE
}
_NC_TYPE_OF = {"S1": 2, ">i2": 3, ">i4": 4, ">f4": 5, ">f8": 6, ">i1": 1}


@dataclass
class _Var:
    name: str
    dimids: Tuple[int, ...]
    attrs: Dict[str, object]
    nc_type: int
    vsize: int
    begin: int
    shape: Tuple[int, ...]      # full shape; record dim reported as numrecs
    is_record: bool


class _Reader:
    """Cursor over the header bytes of a classic-format NetCDF file."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def i4(self) -> int:
        (v,) = struct.unpack_from(">i", self.data, self.off)
        self.off += 4
        return v

    def i8(self) -> int:
        (v,) = struct.unpack_from(">q", self.data, self.off)
        self.off += 8
        return v

    def name(self) -> str:
        n = self.i4()
        raw = self.data[self.off : self.off + n]
        self.off += (n + 3) // 4 * 4
        return raw.decode("utf-8")

    def att_values(self, nc_type: int, nelems: int):
        dt, size = _NC_DTYPES[nc_type]
        raw = self.data[self.off : self.off + nelems * size]
        self.off += (nelems * size + 3) // 4 * 4
        if nc_type == 2:  # char attribute -> python str
            return raw.decode("utf-8", errors="replace")
        vals = np.frombuffer(raw, dtype=dt)
        return vals[0].item() if nelems == 1 else vals

    def att_list(self) -> Dict[str, object]:
        tag = self.i4()
        count = self.i4()
        if tag == 0 and count == 0:
            return {}
        if tag != _NC_ATTRIBUTE:
            raise ValueError(f"bad attribute-list tag 0x{tag:x}")
        out: Dict[str, object] = {}
        for _ in range(count):
            name = self.name()
            nc_type = self.i4()
            nelems = self.i4()
            out[name] = self.att_values(nc_type, nelems)
        return out


def _parse_header(data: bytes):
    """Parse the classic-format header.

    Returns (version, numrecs, dims [(name, size)], gattrs, vars).
    """
    if data[:3] != b"CDF":
        raise ValueError("not a NetCDF classic file (bad magic)")
    version = data[3]
    if version not in (1, 2):
        raise ValueError(
            f"unsupported NetCDF variant {version} (only classic CDF-1 "
            "and 64-bit-offset CDF-2 are supported, not CDF-5/HDF5)"
        )
    r = _Reader(data)
    r.off = 4
    numrecs = r.i4()

    tag = r.i4()
    count = r.i4()
    dims: List[Tuple[str, int]] = []
    if tag == _NC_DIMENSION:
        for _ in range(count):
            dims.append((r.name(), r.i4()))
    elif not (tag == 0 and count == 0):
        raise ValueError(f"bad dimension-list tag 0x{tag:x}")

    gattrs = r.att_list()

    tag = r.i4()
    count = r.i4()
    variables: List[_Var] = []
    if tag == _NC_VARIABLE:
        for _ in range(count):
            name = r.name()
            rank = r.i4()
            dimids = tuple(r.i4() for _ in range(rank))
            attrs = r.att_list()
            nc_type = r.i4()
            vsize = r.i4()
            begin = r.i4() if version == 1 else r.i8()
            is_record = bool(rank) and dims[dimids[0]][1] == 0
            shape = tuple(
                numrecs if dims[d][1] == 0 else dims[d][1] for d in dimids
            )
            variables.append(
                _Var(name, dimids, attrs, nc_type, vsize, begin, shape,
                     is_record)
            )
    elif not (tag == 0 and count == 0):
        raise ValueError(f"bad variable-list tag 0x{tag:x}")

    return version, numrecs, dims, gattrs, variables


def _read_var(data: bytes, v: _Var, numrecs: int, recsize: int) -> np.ndarray:
    dt, size = _NC_DTYPES[v.nc_type]
    if not v.is_record:
        n = int(np.prod(v.shape, dtype=np.int64)) if v.shape else 1
        arr = np.frombuffer(data, dtype=dt, count=n, offset=v.begin)
        return arr.reshape(v.shape)
    # Record variable: one slab of per_rec elements every `recsize` bytes.
    per_rec = int(np.prod(v.shape[1:], dtype=np.int64)) if len(v.shape) > 1 else 1
    # Tolerate truncated files (match read_dcd): only whole records count.
    if numrecs > 0:
        whole = (len(data) - v.begin - per_rec * size) // recsize + 1
        numrecs = max(0, min(numrecs, whole))
    if numrecs == 0:
        return np.zeros((0,) + v.shape[1:], dtype=dt)
    # Strided bulk gather over the raw buffer (no per-frame Python loop).
    raw = np.frombuffer(data, dtype=np.uint8)
    base = np.lib.stride_tricks.as_strided(
        raw[v.begin :],
        shape=(numrecs, per_rec * size),
        strides=(recsize, 1),
        writeable=False,
    )
    flat = np.ascontiguousarray(base).view(dt)
    return flat.reshape((numrecs,) + v.shape[1:])


def _record_size(variables: Sequence[_Var]) -> int:
    rec_vars = [v for v in variables if v.is_record]
    if len(rec_vars) == 1:
        # Special case in the spec: a single record variable is packed
        # with no inter-record padding.
        v = rec_vars[0]
        per = int(np.prod(v.shape[1:], dtype=np.int64)) if len(v.shape) > 1 else 1
        return per * _NC_DTYPES[v.nc_type][1]
    return sum(v.vsize for v in rec_vars)


@dataclass
class NetCDFFrames:
    """Full decoded contents of an Amber NetCDF trajectory (quantities
    absent from the file are None). Units are as stored: angstroms for
    coordinates/cell lengths, picoseconds for time, degrees for angles."""

    coords: Optional[np.ndarray]        # [n, natoms, 3] float32, angstrom
    velocities: Optional[np.ndarray]    # [n, natoms, 3] float32
    cell_lengths: Optional[np.ndarray]  # [n, 3] float64, angstrom
    cell_angles: Optional[np.ndarray]   # [n, 3] float64, degree
    times: Optional[np.ndarray]         # [n] float32, ps
    attrs: Dict[str, object]            # global attributes

    @property
    def n_frames(self) -> int:
        for a in (self.coords, self.velocities, self.times):
            if a is not None:
                return len(a)
        return 0


def read_netcdf_full(filename: str) -> NetCDFFrames:
    """Decode every Amber-convention quantity in a NetCDF trajectory."""
    with open(filename, "rb") as f:
        data = f.read()
    _version, numrecs, _dims, gattrs, variables = _parse_header(data)
    recsize = _record_size(variables)
    if numrecs < 0:  # STREAMING sentinel: infer the record count
        rec_begin = min(
            (v.begin for v in variables if v.is_record), default=len(data)
        )
        numrecs = (len(data) - rec_begin) // recsize if recsize else 0
        for v in variables:
            if v.is_record:
                v.shape = (numrecs,) + v.shape[1:]
    # Truncation tolerance must be CONSISTENT across variables: clamp to
    # the record count every record variable has in full, so times and
    # coords stay aligned when the file is cut mid-record.
    for v in variables:
        if not v.is_record or numrecs <= 0:
            continue
        per = (
            int(np.prod(v.shape[1:], dtype=np.int64))
            if len(v.shape) > 1
            else 1
        ) * _NC_DTYPES[v.nc_type][1]
        whole = (len(data) - v.begin - per) // recsize + 1
        numrecs = max(0, min(numrecs, whole))
    for v in variables:
        if v.is_record:
            v.shape = (numrecs,) + v.shape[1:]
    by_name = {v.name: v for v in variables}

    def get(name: str, dtype=None, scale=True) -> Optional[np.ndarray]:
        v = by_name.get(name)
        if v is None:
            return None
        arr = _read_var(data, v, numrecs, recsize)
        if dtype is not None:
            arr = np.ascontiguousarray(arr, dtype=dtype)
        sf = v.attrs.get("scale_factor")
        if scale and sf is not None and sf != 1.0:
            arr = arr * np.asarray(sf, dtype=arr.dtype)
        return arr

    return NetCDFFrames(
        coords=get("coordinates", np.float32),
        velocities=get("velocities", np.float32),
        cell_lengths=get("cell_lengths", np.float64),
        cell_angles=get("cell_angles", np.float64),
        times=get("time", np.float32),
        attrs=gattrs,
    )


def read_netcdf(filename: str):
    """Read an Amber NetCDF trajectory.

    Returns ``(coords [n_frames, n_atoms, 3] float32, dt_ps, times [n])``
    — the same contract as :func:`~colvarsfinder_tpu_torch.utils.xtc.read_xtc` /
    :func:`~colvarsfinder_tpu_torch.utils.trr.read_trr`. Coordinates are as
    stored (angstroms per the Amber convention). ``dt_ps`` is the spacing
    of the time variable (1.0 when absent or single-frame).
    """
    fr = read_netcdf_full(filename)
    if fr.coords is None:
        raise ValueError(f"{filename}: no 'coordinates' variable")
    times = fr.times
    if times is None:
        times = np.arange(len(fr.coords), dtype=np.float32)
    dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
    return fr.coords, dt, np.asarray(times, dtype=np.float64)


def scan_netcdf(filename: str) -> Dict[str, object]:
    """Header-only metadata scan (no frame decode): frame/atom counts,
    which quantities are present, and the global attributes."""
    with open(filename, "rb") as f:
        data = f.read(1 << 22)  # classic headers are KBs; 4 MiB is ample
    _version, numrecs, dims, gattrs, variables = _parse_header(data)
    if numrecs < 0:  # STREAMING sentinel: infer from the file size
        import os as _os

        size = _os.path.getsize(filename)
        recsize = _record_size(variables)
        rec_begin = min(
            (v.begin for v in variables if v.is_record), default=size
        )
        numrecs = (size - rec_begin) // recsize if recsize else 0
    dsize = dict(dims)
    names = {v.name for v in variables}
    return {
        "n_frames": numrecs,
        "n_atoms": int(dsize.get("atom", 0)),
        "has_coordinates": "coordinates" in names,
        "has_velocities": "velocities" in names,
        "has_cell": "cell_lengths" in names,
        "conventions": gattrs.get("Conventions", ""),
        "title": gattrs.get("title", ""),
        "attrs": gattrs,
    }


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


def _enc_name(name: str) -> bytes:
    raw = name.encode("utf-8")
    return struct.pack(">i", len(raw)) + _pad4(raw)


def _enc_att(name: str, value) -> bytes:
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return (
            _enc_name(name)
            + struct.pack(">ii", 2, len(raw))
            + _pad4(raw)
        )
    arr = np.atleast_1d(np.asarray(value))
    if arr.dtype.kind == "f":
        arr = arr.astype(">f8")
    else:
        arr = arr.astype(">i4")
    nc_type = _NC_TYPE_OF[arr.dtype.str.lstrip("=")]
    return (
        _enc_name(name)
        + struct.pack(">ii", nc_type, arr.size)
        + _pad4(arr.tobytes())
    )


def _enc_att_list(attrs: Dict[str, object]) -> bytes:
    if not attrs:
        return struct.pack(">ii", 0, 0)
    out = struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))
    for k, v in attrs.items():
        out += _enc_att(k, v)
    return out


def write_netcdf(
    filename: str,
    coords: np.ndarray,
    dt_ps: float = 1.0,
    times: Optional[np.ndarray] = None,
    velocities: Optional[np.ndarray] = None,
    cell_lengths: Optional[np.ndarray] = None,
    cell_angles: Optional[np.ndarray] = None,
    title: str = "",
) -> None:
    """Write an Amber-convention NetCDF trajectory (classic format).

    Args:
        coords: ``[n_frames, n_atoms, 3]`` coordinates, written float32
            exactly as given (the Amber convention stores angstroms).
        dt_ps: frame spacing used to synthesize the ``time`` variable
            when ``times`` is not given.
        times: optional explicit per-frame times (ps).
        velocities: optional ``[n_frames, n_atoms, 3]`` velocities.
        cell_lengths / cell_angles: optional ``[n_frames, 3]`` unit-cell
            records (angstroms / degrees); both or neither.
        title: free-form title global attribute.

    The file uses CDF-1 (32-bit offsets), switching to CDF-2 when the
    data section would cross the 2 GiB offset limit.
    """
    coords = np.ascontiguousarray(coords, dtype=">f4")
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError("coords must be [n_frames, n_atoms, 3]")
    n_frames, n_atoms = coords.shape[:2]
    if (cell_lengths is None) != (cell_angles is None):
        raise ValueError("cell_lengths and cell_angles go together")
    if times is None:
        times_arr = (np.arange(n_frames) * float(dt_ps)).astype(">f4")
    else:
        times_arr = np.ascontiguousarray(times, dtype=">f4")
        if times_arr.shape != (n_frames,):
            raise ValueError("times must have one entry per frame")
    if velocities is not None:
        velocities = np.ascontiguousarray(velocities, dtype=">f4")
        if velocities.shape != coords.shape:
            raise ValueError("velocities must match coords shape")
    has_cell = cell_lengths is not None
    if has_cell:
        cell_lengths = np.ascontiguousarray(cell_lengths, dtype=">f8")
        cell_angles = np.ascontiguousarray(cell_angles, dtype=">f8")
        if cell_lengths.shape != (n_frames, 3) or cell_angles.shape != (
            n_frames,
            3,
        ):
            raise ValueError("cell records must be [n_frames, 3]")

    # --- dimensions -------------------------------------------------------
    dims: List[Tuple[str, int]] = [
        ("frame", 0),  # UNLIMITED
        ("spatial", 3),
        ("atom", n_atoms),
    ]
    if has_cell:
        dims += [("cell_spatial", 3), ("cell_angular", 3), ("label", 5)]
    dimid = {name: i for i, (name, _) in enumerate(dims)}

    # --- variables (varid order == record interleave order) --------------
    # (name, dims, nc_type, attrs, payload-or-None-for-record)
    fixed: List[Tuple[str, Tuple[str, ...], int, Dict[str, object], bytes]] = [
        ("spatial", ("spatial",), 2, {}, b"xyz"),
    ]
    if has_cell:
        fixed += [
            ("cell_spatial", ("cell_spatial",), 2, {}, b"abc"),
            (
                "cell_angular",
                ("cell_angular", "label"),
                2,
                {},
                b"alpha" + b"beta " + b"gamma",
            ),
        ]
    record: List[Tuple[str, Tuple[str, ...], int, Dict[str, object], np.ndarray]] = [
        ("time", ("frame",), 5, {"units": "picosecond"}, times_arr),
        (
            "coordinates",
            ("frame", "atom", "spatial"),
            5,
            {"units": "angstrom"},
            coords,
        ),
    ]
    if velocities is not None:
        record.append(
            (
                "velocities",
                ("frame", "atom", "spatial"),
                5,
                {"units": "angstrom/picosecond"},
                velocities,
            )
        )
    if has_cell:
        record += [
            (
                "cell_lengths",
                ("frame", "cell_spatial"),
                6,
                {"units": "angstrom"},
                cell_lengths,
            ),
            (
                "cell_angles",
                ("frame", "cell_angular"),
                6,
                {"units": "degree"},
                cell_angles,
            ),
        ]

    def per_item_size(dims_of: Tuple[str, ...], nc_type: int, is_rec: bool):
        sizes = [dict(dims)[d] for d in dims_of]
        if is_rec:
            sizes = sizes[1:]
        n = int(np.prod(sizes, dtype=np.int64)) if sizes else 1
        raw = n * _NC_DTYPES[nc_type][1]
        return raw, (raw + 3) // 4 * 4

    # vsize per variable; record slab padding only matters with >1 record var
    n_rec_vars = len(record)
    rec_raw_padded = [
        per_item_size(d, t, True) for (_, d, t, _, _) in record
    ]
    recsize = (
        rec_raw_padded[0][0]
        if n_rec_vars == 1
        else sum(p for (_r, p) in rec_raw_padded)
    )

    # --- header assembly (two passes: sizes, then offsets) ---------------
    def header_bytes(version: int, begins: List[int]) -> bytes:
        off_fmt = ">i" if version == 1 else ">q"
        out = b"CDF" + bytes([version]) + struct.pack(">i", n_frames)
        out += struct.pack(">ii", _NC_DIMENSION, len(dims))
        for name, size in dims:
            out += _enc_name(name) + struct.pack(">i", size)
        out += _enc_att_list(
            {
                "Conventions": "AMBER",
                "ConventionVersion": "1.0",
                "program": "colvarsfinder_tpu",
                "programVersion": "1.0",
                "title": title or "colvarsfinder_tpu trajectory",
            }
        )
        all_vars = [(n, d, t, a) for (n, d, t, a, _) in fixed] + [
            (n, d, t, a) for (n, d, t, a, _) in record
        ]
        out += struct.pack(">ii", _NC_VARIABLE, len(all_vars))
        for i, (name, vdims, nc_type, attrs) in enumerate(all_vars):
            is_rec = i >= len(fixed)
            _raw, padded = per_item_size(vdims, nc_type, is_rec)
            out += _enc_name(name)
            out += struct.pack(">i", len(vdims))
            for d in vdims:
                out += struct.pack(">i", dimid[d])
            out += _enc_att_list(attrs)
            out += struct.pack(">ii", nc_type, padded)
            out += struct.pack(off_fmt, begins[i])
        return out

    n_vars = len(fixed) + len(record)

    def layout(version: int) -> Tuple[List[int], int]:
        hdr_len = len(header_bytes(version, [0] * n_vars))
        begins: List[int] = []
        off = hdr_len
        for name, vdims, nc_type, attrs, payload in fixed:
            begins.append(off)
            off += (len(payload) + 3) // 4 * 4
        rec_start = off
        for j, (_n, d, t, _a, _p) in enumerate(record):
            begins.append(rec_start + sum(
                rec_raw_padded[jj][1] if n_rec_vars > 1 else 0
                for jj in range(j)
            ))
        end = rec_start + n_frames * recsize
        return begins, end

    version = 1
    begins, end = layout(version)
    if end >= 2**31 - 1:
        version = 2
        begins, end = layout(version)

    hdr = header_bytes(version, begins)
    with open(filename, "wb") as f:
        f.write(hdr)
        for _n, _d, _t, _a, payload in fixed:
            f.write(_pad4(payload))
        if n_rec_vars == 1:
            f.write(record[0][4].tobytes())
        else:
            # Interleave per-record slabs (each padded to 4 bytes),
            # assembled in bounded chunks so multi-GiB trajectories never
            # materialize 3-4x their size in RAM.
            byte_rows = []
            for (j, (_n, _d, _t, _a, payload)) in enumerate(record):
                raw, _padded = rec_raw_padded[j]
                byte_rows.append(
                    payload.reshape(n_frames, -1).view(np.uint8).reshape(
                        n_frames, raw
                    )
                )
            chunk = max(1, (1 << 27) // max(recsize, 1))
            buf = np.zeros((min(chunk, n_frames), recsize), np.uint8)
            col_of = np.cumsum(
                [0] + [p for (_r, p) in rec_raw_padded[:-1]]
            )
            for lo in range(0, n_frames, chunk):
                hi = min(lo + chunk, n_frames)
                b = buf[: hi - lo]
                for j, rows in enumerate(byte_rows):
                    raw = rec_raw_padded[j][0]
                    b[:, col_of[j] : col_of[j] + raw] = rows[lo:hi]
                f.write(b.tobytes())


def read_netcdf_memmap(filename: str, out_path: str):
    """Decode coordinates DIRECTLY into an on-disk ``.npy`` memmap — the
    Amber-trajectory entry to the tasks' ``streaming=True`` layout
    (counterpart of :func:`~colvarsfinder_tpu_torch.utils.xtc.read_xtc_memmap`).

    Both sides stay out of RAM: the source file is memory-mapped and the
    big-endian record slabs are converted chunk-by-chunk into the
    ``open_memmap`` output pages.

    Returns ``(coords_memmap [n_frames, n_atoms, 3] float32, dt_ps,
    times_ps)``.
    """
    from numpy.lib.format import open_memmap

    # the classic header is tiny (KBs); 4 MiB covers pathological cases
    with open(filename, "rb") as f:
        head = f.read(1 << 22)
    _version, numrecs, _dims, _gattrs, variables = _parse_header(head)
    recsize = _record_size(variables)
    by_name = {v.name: v for v in variables}
    v = by_name.get("coordinates")
    if v is None:
        raise ValueError(f"{filename}: no 'coordinates' variable")
    if not v.is_record or len(v.shape) != 3:
        raise ValueError("'coordinates' must be (frame, atom, spatial)")
    n_atoms = v.shape[1]
    per = n_atoms * 3 * _NC_DTYPES[v.nc_type][1]
    dt_np, _size = _NC_DTYPES[v.nc_type]

    src = np.memmap(filename, dtype=np.uint8, mode="r")
    if numrecs < 0:  # STREAMING sentinel
        rec_begin = min(
            (vv.begin for vv in variables if vv.is_record), default=len(src)
        )
        numrecs = (len(src) - rec_begin) // recsize if recsize else 0
    if numrecs > 0:  # tolerate truncation (whole records only)
        whole = (len(src) - v.begin - per) // recsize + 1
        numrecs = max(0, min(numrecs, whole))

    coords = open_memmap(
        out_path, mode="w+", dtype=np.float32,
        shape=(int(numrecs), int(n_atoms), 3),
    )
    if numrecs == 0:
        times = np.zeros(0, dtype=np.float64)
        return coords, 1.0, times

    view = np.lib.stride_tricks.as_strided(
        src[v.begin :], shape=(numrecs, per), strides=(recsize, 1),
        writeable=False,
    )
    sf = v.attrs.get("scale_factor")
    sf = None if sf in (None, 1.0) else np.float32(sf)
    chunk = max(1, (1 << 27) // max(per, 1))  # ~128 MiB of source per pass
    for lo in range(0, numrecs, chunk):
        blk = np.ascontiguousarray(view[lo : lo + chunk]).view(dt_np)
        out_blk = blk.reshape(-1, n_atoms, 3).astype(np.float32)
        if sf is not None:
            out_blk *= sf
        coords[lo : lo + chunk] = out_blk

    tv = by_name.get("time")
    if tv is not None and tv.is_record:
        tsize = _NC_DTYPES[tv.nc_type][1]
        traw = np.lib.stride_tricks.as_strided(
            src[tv.begin :], shape=(numrecs, tsize), strides=(recsize, 1),
            writeable=False,
        )
        times = (
            np.ascontiguousarray(traw)
            .view(_NC_DTYPES[tv.nc_type][0])
            .reshape(-1)
            .astype(np.float64)
        )
    else:
        times = np.arange(numrecs, dtype=np.float64)
    dt = float(times[1] - times[0]) if numrecs > 1 else 1.0
    return coords, dt, times
