"""H5MD trajectory codec (HDF5-based; gated on ``h5py``).

Copied from ``colvarsfinder_tpu/utils/h5md.py``: host-side numpy,
the imports adapted to the port.

H5MD (de Buyl, Colberg & Höfling 2014) is the HDF5 trajectory layout
written by LAMMPS' ``dump h5md``, ESPResSo, and several analysis stacks.
The subset read here is the standard particles tree::

    /h5md/version
    /particles/<group>/position/value   [n_frames, n_atoms, 3]
    /particles/<group>/position/time    [n_frames]   (optional)
    /particles/<group>/position/step    [n_frames]   (optional)

yielding the same ``(coords, dt, times)`` contract as the other readers.
A writer covers round-trip testing and export. ``h5py`` is imported
lazily — the rest of the package works without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["read_h5md", "write_h5md"]


def _h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "H5MD support requires h5py (pip install h5py)"
        ) from e
    return h5py


def read_h5md(
    path: str,
    group: Optional[str] = None,
    length_scale: float = 1.0,
):
    """Read an H5MD trajectory.

    Args:
        path: the ``.h5``/``.h5md`` file.
        group: particles group name (default: the single group under
            ``/particles``; required when there are several).
        length_scale: file length unit -> nm (H5MD files carry engine
            units; LAMMPS ``units real`` H5MD dumps are Angstrom:
            pass 0.1).

    Returns:
        ``(coords [n, atoms, 3], dt_ps, times)`` — ``dt`` from the time
        dataset when present, else from ``step`` spacing (counts), else
        -1 (no timing info; :class:`~colvarsfinder_tpu_torch.utils.Universe`
        then uses ``dt_ps``).
    """
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        if "particles" not in f:
            raise ValueError(f"{path}: no /particles group (not H5MD?)")
        groups = list(f["particles"].keys())
        if group is None:
            if len(groups) != 1:
                raise ValueError(
                    f"{path}: {len(groups)} particles groups {groups}; "
                    "pass group="
                )
            group = groups[0]
        elif group not in groups:
            raise ValueError(
                f"{path}: no particles group {group!r} (have {groups})"
            )
        node = f["particles"][group]
        if "position" not in node or "value" not in node["position"]:
            raise ValueError(
                f"{path}: particles/{group} has no position/value dataset"
            )
        pos = node["position"]
        coords = np.asarray(pos["value"], dtype=np.float32) * float(
            length_scale
        )
        if coords.ndim != 3 or coords.shape[-1] != 3:
            raise ValueError(
                f"{path}: position/value has shape {coords.shape}, "
                "expected [n_frames, n_atoms, 3]"
            )
        n = coords.shape[0]
        times = None
        if "time" in pos:
            t = np.asarray(pos["time"], dtype=np.float64).reshape(-1)
            if t.shape[0] == n:
                times = t
        if times is not None and n > 1:
            dt = float(times[1] - times[0])
            if not np.allclose(np.diff(times), dt, rtol=1e-6, atol=1e-12):
                raise ValueError(f"{path}: uneven frame times")
        elif times is None and "step" in pos and n > 1:
            steps = np.asarray(pos["step"]).reshape(-1)
            d = np.diff(steps)
            if d.size and not np.all(d == d[0]):
                raise ValueError(f"{path}: uneven step intervals")
            # step counts are not time: report "no timing info"
            dt = -1.0
            times = steps.astype(np.float64)
        else:
            dt = -1.0 if times is None else 1.0
            if times is None:
                times = np.arange(n, dtype=np.float64)
    return coords, dt, times


def write_h5md(
    path: str,
    coords,
    dt_ps: Optional[float] = None,
    times=None,
    group: str = "all",
    length_scale: float = 1.0,
    author: str = "colvarsfinder-tpu",
):
    """Write an H5MD trajectory (position value/time/step + metadata).

    Args:
        path: output ``.h5`` file.
        coords: [n_frames, n_atoms, 3] positions in nm.
        dt_ps: frame spacing — writes ``time = arange(n) * dt_ps``.
        times: explicit per-frame times (overrides ``dt_ps``).
        group: particles group name.
        length_scale: nm -> file length unit (10.0 writes Angstrom).
    """
    h5py = _h5py()
    coords = np.asarray(coords, dtype=np.float32)
    n = coords.shape[0]
    if times is None:
        times = np.arange(n, dtype=np.float64) * (
            1.0 if dt_ps is None else float(dt_ps)
        )
    with h5py.File(path, "w") as f:
        meta = f.create_group("h5md")
        meta.attrs["version"] = np.array([1, 1])
        meta.create_group("author").attrs["name"] = author
        meta.create_group("creator").attrs["name"] = "colvarsfinder-tpu"
        pos = f.create_group(f"particles/{group}/position")
        pos.create_dataset(
            "value", data=coords * float(length_scale)
        )
        pos.create_dataset("time", data=np.asarray(times, np.float64))
        pos.create_dataset("step", data=np.arange(n, dtype=np.int64))
