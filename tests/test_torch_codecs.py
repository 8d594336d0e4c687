"""PyTorch port, the trajectory codecs: each port writer byte-equal to the
JAX package's on the same seeded frames, each port reader bit for bit
the JAX reader on the JAX package's files, the header scans and the memmap
readers equal, and the native decoders (``native/fastio.cpp``, built by the
port) bit for bit the pure-Python codecs."""

import dataclasses

import numpy as np
import pytest

from colvarsfinder_tpu.utils import (
    h5md as jh5,
    lammps as jlmp,
    netcdf as jnc,
    trr as jtrr,
    xtc as jxtc,
)

from colvarsfinder_tpu_torch.utils import (
    h5md as th5,
    lammps as tlmp,
    native_io,
    netcdf as tnc,
    trr as ttrr,
    xtc as txtc,
)
from colvarsfinder_tpu_torch.utils import io as tio
from colvarsfinder_tpu_torch.utils import trajectory as ttr

N_FRAMES = 24


def _frames(n_atoms, seed=0, n=N_FRAMES):
    rng = np.random.default_rng(seed)
    return (3.0 + 2.0 * rng.standard_normal((n, n_atoms, 3))).astype(
        np.float32)


def _same(a, b):
    """Bit for bit: arrays of one dtype with equal bytes, equal scalars,
    tuples and dataclasses field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def _xtc_write(mod, path, x):
    mod.write_xtc(path, x, dt_ps=0.5, precision=1000.0, t0_ps=10.0,
                  step_interval=2)


def _trr_write(mod, path, x):
    rng = np.random.default_rng(1)
    mod.write_trr(path, x, dt_ps=0.25, velocities=rng.standard_normal(
        x.shape), forces=rng.standard_normal(x.shape), box=[3.0, 4.0, 5.0],
        t0_ps=1.0, step_interval=5)
    mod.write_trr(path + ".d.trr", x, dt_ps=0.25, double=True)


def _nc_write(mod, path, x):
    rng = np.random.default_rng(2)
    mod.write_netcdf(path, 10.0 * x, dt_ps=0.5,
                     velocities=rng.standard_normal(x.shape),
                     cell_lengths=np.tile([30.0, 40.0, 50.0], (len(x), 1)),
                     cell_angles=np.tile([90.0, 90.0, 90.0], (len(x), 1)),
                     title="codec parity")


def _lmp_write(mod, path, x):
    mod.write_lammpstrj(path, x, steps=np.arange(len(x)) * 50,
                        types=np.arange(x.shape[1]) % 3 + 1,
                        length_scale=10.0)


def _h5_write(mod, path, x):
    mod.write_h5md(path, x, dt_ps=0.5)


def _xtc_reads(mod, path, tmp_path):
    mm = mod.read_xtc_memmap(path, str(tmp_path / f"{mod.__name__}.npy"))
    return mod.read_xtc(path), mod.scan_xtc(path), (np.asarray(mm[0]),
                                                    mm[1], mm[2])


def _trr_reads(mod, path, tmp_path):
    return (mod.read_trr(path), mod.read_trr(path, full=True),
            mod.scan_trr(path), mod.read_trr(path + ".d.trr", full=True))


def _nc_reads(mod, path, tmp_path):
    mm = mod.read_netcdf_memmap(path, str(tmp_path / f"{mod.__name__}.npy"))
    mm = tuple(np.asarray(v) if isinstance(v, np.ndarray) else v
               for v in mm)
    return (mod.read_netcdf(path), mod.read_netcdf_full(path),
            mod.scan_netcdf(path), mm)


def _lmp_reads(mod, path, tmp_path):
    return (mod.read_lammpstrj(path, length_scale=0.1, dt_ps=0.002),
            mod.read_lammpstrj(path, full=True))


def _h5_reads(mod, path, tmp_path):
    return (mod.read_h5md(path), mod.read_h5md(path, length_scale=0.1))


CODECS = {
    "xtc": (jxtc, txtc, _xtc_write, _xtc_reads),
    "trr": (jtrr, ttrr, _trr_write, _trr_reads),
    "netcdf": (jnc, tnc, _nc_write, _nc_reads),
    "lammps": (jlmp, tlmp, _lmp_write, _lmp_reads),
    "h5md": (jh5, th5, _h5_write, _h5_reads),
}


@pytest.mark.parametrize("fmt", sorted(CODECS))
def test_writer_bytes_and_readers_match_jax(fmt, tmp_path):
    if fmt == "h5md":
        pytest.importorskip("h5py")
    jmod, tmod, write, reads = CODECS[fmt]
    x = _frames(22)
    jpath, tpath = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    write(jmod, jpath, x)
    write(tmod, tpath, x)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    # the port's readers on the JAX package's file, bit for bit
    _same(reads(tmod, jpath, tmp_path), reads(jmod, jpath, tmp_path))


@pytest.mark.parametrize("n_atoms", [3, 9, 10, 22])
def test_xtc_native_and_python_codecs_agree(n_atoms, tmp_path, monkeypatch):
    """Up to 9 atoms XTC stores plain floats; from 10 the bit codec (its
    magicints table, the run lengths of small deltas)."""
    assert native_io.available()
    x = _frames(n_atoms, seed=n_atoms)
    x[5] = x[4] + 1e-3  # small deltas: the run-length branch
    native, jax_file = str(tmp_path / "n.xtc"), str(tmp_path / "j.xtc")
    _xtc_write(txtc, native, x)
    _xtc_write(jxtc, jax_file, x)
    assert open(native, "rb").read() == open(jax_file, "rb").read()
    got_native = txtc.read_xtc(native)
    assert native_io.decode_xtc(native) is not None
    monkeypatch.setattr(native_io, "encode_xtc", lambda *a, **k: False)
    monkeypatch.setattr(native_io, "decode_xtc", lambda *a, **k: None)
    monkeypatch.setattr(native_io, "scan_xtc", lambda *a, **k: None)
    python = str(tmp_path / "p.xtc")
    _xtc_write(txtc, python, x)
    assert open(python, "rb").read() == open(native, "rb").read()
    _same(txtc.read_xtc(native), got_native)
    assert txtc.scan_xtc(native) == (N_FRAMES, n_atoms)
    np.testing.assert_allclose(got_native[0], x, atol=5e-4 + 1e-6)


def test_dcd_and_text_native_and_python_agree(tmp_path, monkeypatch):
    assert native_io.available()
    x = _frames(22, seed=3)
    path = str(tmp_path / "t.dcd")
    tio.write_dcd(path, x, dt_ps=2.0, step_interval=4)
    rng = np.random.default_rng(4)
    data = np.column_stack([np.arange(50) * 0.1,
                            rng.standard_normal((50, 3)) * 1e3])
    txt = tmp_path / "traj.txt"
    txt.write_text("".join(" ".join(repr(v) for v in row) + "\n"
                           for row in data.tolist()))
    native = (tio.read_dcd(path), ttr._load_time_series(str(txt)),
              ttr._load_first_column(str(txt)))
    monkeypatch.setattr(native_io, "decode_dcd_frames",
                        lambda *a, **k: None)
    monkeypatch.setattr(native_io, "load_time_series", lambda *a, **k: None)
    python = (tio.read_dcd(path), ttr._load_time_series(str(txt)),
              ttr._load_first_column(str(txt)))
    _same(native, python)
    _same(native[1], data)  # each number the nearest float64
    np.testing.assert_array_equal(native[0][0], x)
