"""LAMMPS dump ("lammpstrj") trajectory codec.

Copied from ``colvarsfinder_tpu/utils/lammps.py``: host-side numpy,
the imports adapted to the port.

LAMMPS is, next to GROMACS, the major PLUMED-coupled MD engine — a CV
trained here and deployed via :mod:`colvarsfinder_tpu_torch.deploy_plumed` runs
under LAMMPS' ``fix plumed``; this codec closes the data side, reading the
engine's standard text dump (``dump ... custom ... id type x y z``) into
the same ``[n_frames, n_atoms, 3]`` arrays every other reader produces
(reference ingestion counterpart: MDAnalysis' LAMMPSDUMP reader used with
reference utils.py:96-130).

Format (one block per frame)::

    ITEM: TIMESTEP
    <step>
    ITEM: NUMBER OF ATOMS
    <n>
    ITEM: BOX BOUNDS <flags>
    <xlo xhi [xy]>
    <ylo yhi [xz]>
    <zlo zhi [yz]>
    ITEM: ATOMS id type x y z [...]
    <one row per atom, in arbitrary order>

Conventions handled:

* atoms are re-sorted by ``id`` per frame (LAMMPS dumps in spatial-bin
  order by default);
* coordinate columns are found by NAME in the ATOMS header — unscaled
  (``x y z``), unwrapped (``xu yu zu``, preferred when both exist), or
  scaled (``xs ys zs`` / ``xsu ysu zsu``, unscaled by the box bounds);
* ``length_scale`` converts the dump's length unit to the framework's
  nm (LAMMPS ``units real``/``metal`` are Angstrom: pass 0.1; ``lj`` is
  dimensionless: keep 1.0);
* ``dt_ps`` converts TIMESTEP counters to time: frame spacing =
  (step[1] - step[0]) * dt_ps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["read_lammpstrj", "write_lammpstrj", "LAMMPSFrames"]


@dataclasses.dataclass
class LAMMPSFrames:
    """Full decode result of :func:`read_lammpstrj`.

    Attributes:
        coords: [n_frames, n_atoms, 3] positions (sorted by atom id).
        steps: [n_frames] TIMESTEP counters.
        box: [n_frames, 3, 2] (lo, hi) bounds per axis.
        ids: [n_atoms] atom ids (sorted).
        types: [n_atoms] atom types (first frame's).
    """

    coords: np.ndarray
    steps: np.ndarray
    box: np.ndarray
    ids: np.ndarray
    types: np.ndarray


_COORD_SETS = (  # preference order; (names, scaled-by-box?)
    (("xu", "yu", "zu"), False),
    (("x", "y", "z"), False),
    (("xsu", "ysu", "zsu"), True),
    (("xs", "ys", "zs"), True),
)


def _read_full(path: str, length_scale: float) -> LAMMPSFrames:
    frames, steps, boxes = [], [], []
    ids0 = types0 = None
    with open(path) as f:
        lines = f.read().split("\n")
    i, n_lines = 0, len(lines)
    while i < n_lines:
        ln = lines[i].strip()
        if not ln:
            i += 1
            continue
        if not ln.startswith("ITEM: TIMESTEP"):
            raise ValueError(
                f"{path}: expected 'ITEM: TIMESTEP' at line {i + 1}, "
                f"got {ln!r}"
            )
        step = int(lines[i + 1].split()[0])
        if not lines[i + 2].startswith("ITEM: NUMBER OF ATOMS"):
            raise ValueError(f"{path}: malformed frame header at line {i + 3}")
        n_atoms = int(lines[i + 3].split()[0])
        if not lines[i + 4].startswith("ITEM: BOX BOUNDS"):
            raise ValueError(f"{path}: missing BOX BOUNDS at line {i + 5}")
        bounds_flags = lines[i + 4].split()[3:]
        triclinic = any(t in ("xy", "xz", "yz") for t in bounds_flags)
        box = np.array(
            [
                [float(v) for v in lines[i + 5 + a].split()[:2]]
                for a in range(3)
            ]
        )
        atoms_hdr = lines[i + 8]
        if not atoms_hdr.startswith("ITEM: ATOMS"):
            raise ValueError(f"{path}: missing ATOMS header at line {i + 9}")
        cols = atoms_hdr.split()[2:]
        col_ix = {c: j for j, c in enumerate(cols)}
        if "id" not in col_ix:
            raise ValueError(f"{path}: ATOMS dump must include the id column")
        for names, scaled in _COORD_SETS:
            if all(nm in col_ix for nm in names):
                cix = [col_ix[nm] for nm in names]
                break
        else:
            raise ValueError(
                f"{path}: no coordinate columns found in {cols} "
                "(need x y z / xu yu zu / xs ys zs / xsu ysu zsu)"
            )
        # triclinic cells: scaled columns need the tilt transform
        # x = xlo + xs*lx + ys*xy + zs*xz (with TRUE lo/hi, not the
        # dumped bound values) and wrapped x y z + image flags need the
        # tilt vectors to unwrap — refuse rather than silently corrupt
        unwrap_ix = None
        if names == ("x", "y", "z") and all(
            nm in col_ix for nm in ("ix", "iy", "iz")
        ):
            unwrap_ix = [col_ix[nm] for nm in ("ix", "iy", "iz")]
        if triclinic and (scaled or unwrap_ix is not None):
            raise ValueError(
                f"{path}: triclinic BOX BOUNDS ({' '.join(bounds_flags)}) "
                "with scaled or wrapped+image-flag coordinates is not "
                "supported — dump unscaled unwrapped coordinates "
                "(xu yu zu) instead"
            )
        block = lines[i + 9: i + 9 + n_atoms]
        rows = [r.split() for r in block]
        if len(rows) != n_atoms or any(len(r) != len(cols) for r in rows):
            raise ValueError(
                f"{path}: truncated frame at step {step} "
                f"({sum(len(r) == len(cols) for r in rows)}/{n_atoms} "
                "complete atom rows)"
            )
        data = np.array(rows, dtype=object)
        fids = data[:, col_ix["id"]].astype(np.int64)
        order = np.argsort(fids, kind="stable")
        xyz = data[:, cix].astype(np.float64)[order]
        if scaled:
            lo, hi = box[:, 0], box[:, 1]
            xyz = lo[None, :] + xyz * (hi - lo)[None, :]
        elif unwrap_ix is not None:
            # periodic-wrapped coordinates + image flags: unwrap so
            # molecules stay whole across box faces
            imgs = data[:, unwrap_ix].astype(np.float64)[order]
            lo, hi = box[:, 0], box[:, 1]
            xyz = xyz + imgs * (hi - lo)[None, :]
        if ids0 is None:
            ids0 = fids[order]
            types0 = (
                data[:, col_ix["type"]].astype(np.int64)[order]
                if "type" in col_ix
                else np.ones(n_atoms, dtype=np.int64)
            )
        elif not np.array_equal(fids[order], ids0):
            raise ValueError(
                f"{path}: atom ids change between frames (step {step})"
            )
        frames.append(xyz * length_scale)
        steps.append(step)
        boxes.append(box * length_scale)
        i += 9 + n_atoms
    if not frames:
        raise ValueError(f"{path}: no frames")
    return LAMMPSFrames(
        coords=np.asarray(frames, dtype=np.float32),
        steps=np.asarray(steps, dtype=np.int64),
        box=np.asarray(boxes),
        ids=ids0,
        types=types0,
    )


def read_lammpstrj(
    path: str,
    length_scale: float = 1.0,
    dt_ps: Optional[float] = None,
    full: bool = False,
):
    """Read a LAMMPS text dump.

    Args:
        path: the ``.lammpstrj`` file.
        length_scale: dump length unit -> nm (0.1 for ``units real`` /
            ``metal`` Angstrom dumps; 1.0 for ``lj``).
        dt_ps: integrator timestep in ps — frame spacing becomes
            ``(steps[1] - steps[0]) * dt_ps``. Default 1.0 per step.
        full: return the :class:`LAMMPSFrames` record instead.

    Returns:
        ``(coords [n, atoms, 3], dt_ps_between_frames, times)`` —
        the same contract as the other trajectory readers — or
        :class:`LAMMPSFrames` when ``full``.
    """
    rec = _read_full(path, float(length_scale))
    if full:
        return rec
    per_step = 1.0 if dt_ps is None else float(dt_ps)
    if len(rec.steps) > 1:
        dt = float(rec.steps[1] - rec.steps[0]) * per_step
        diffs = np.diff(rec.steps)
        if diffs.size and not np.all(diffs == diffs[0]):
            raise ValueError(
                f"{path}: uneven dump intervals {sorted(set(diffs))}"
            )
    else:
        dt = per_step
    times = rec.steps * per_step
    return rec.coords, dt, times.astype(np.float64)


def write_lammpstrj(
    path: str,
    coords,
    steps=None,
    box=None,
    types=None,
    length_scale: float = 1.0,
):
    """Write a LAMMPS ``dump custom id type x y z`` text trajectory.

    Args:
        path: output file.
        coords: [n_frames, n_atoms, 3] positions in nm.
        steps: [n_frames] TIMESTEP counters (default 0, 1, 2, ...).
        box: [3, 2] or [n_frames, 3, 2] (lo, hi) bounds in nm (default:
            a bounding box with 10% margin).
        types: [n_atoms] atom types (default all 1).
        length_scale: nm -> dump length unit (10.0 writes Angstrom for
            ``units real``/``metal``; the inverse of the reader's).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n_frames, n_atoms, _ = coords.shape
    if steps is None:
        steps = np.arange(n_frames)
    if types is None:
        types = np.ones(n_atoms, dtype=np.int64)
    if box is None:
        lo = coords.min(axis=(0, 1)) - 0.05 * np.ptp(
            coords, axis=(0, 1)
        ) - 1e-9
        hi = coords.max(axis=(0, 1)) + 0.05 * np.ptp(
            coords, axis=(0, 1)
        ) + 1e-9
        box = np.stack([lo, hi], axis=1)
    box = np.asarray(box, dtype=np.float64)
    if box.ndim == 2:
        box = np.broadcast_to(box, (n_frames, 3, 2))
    s = float(length_scale)
    with open(path, "w") as f:
        for fi in range(n_frames):
            f.write("ITEM: TIMESTEP\n%d\n" % int(steps[fi]))
            f.write("ITEM: NUMBER OF ATOMS\n%d\n" % n_atoms)
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for a in range(3):
                f.write(
                    "%.10g %.10g\n"
                    % (box[fi, a, 0] * s, box[fi, a, 1] * s)
                )
            f.write("ITEM: ATOMS id type x y z\n")
            xyz = coords[fi] * s
            for j in range(n_atoms):
                f.write(
                    "%d %d %.8g %.8g %.8g\n"
                    % (j + 1, int(types[j]), xyz[j, 0], xyz[j, 1], xyz[j, 2])
                )
