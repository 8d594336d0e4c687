"""PyTorch port, topology and trajectory input: the selection language,
the .gro / .pdb / DCD readers and writers and Universe, each against the
JAX package's on the same files."""

import numpy as np
import pytest

from colvarsfinder_tpu.utils import io as jio
from colvarsfinder_tpu.utils import lammps as jlmp
from colvarsfinder_tpu.utils import netcdf as jnc
from colvarsfinder_tpu.utils import trr as jtrr
from colvarsfinder_tpu.utils import xtc as jxtc

from colvarsfinder_tpu_torch.utils import io as tio

NAMES = ["HH31", "CH3", "HH32", "HH33", "C", "O",
         "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O",
         "N", "H", "CH3", "HH31", "HH32", "HH33"]
RESIDS = [1] * 6 + [2] * 10 + [3] * 6
RESNAMES = ["ACE"] * 6 + ["ALA"] * 10 + ["NME"] * 6


def _topology(mod, seed=0, box=(2.5251, 2.7648, 2.3021)):
    pos = np.random.default_rng(seed).uniform(0.0, 2.0, (22, 3))
    return mod.Topology(names=list(NAMES), resids=list(RESIDS),
                        resnames=list(RESNAMES),
                        positions=pos.astype(np.float32),
                        box=None if box is None else np.asarray(box),
                        title="ACE-ALA-NME")


def _pdb(path, top):
    lines = ["TITLE     ACE-ALA-NME\n",
             "CRYST1   25.251   27.648   23.021  90.00  90.00  90.00\n"]
    for i, (n, r, rn) in enumerate(zip(top.names, top.resids,
                                       top.resnames)):
        x, y, z = 10.0 * top.positions[i]
        lines.append(f"ATOM  {i + 1:5d} {n:<4s} {rn:<4s} {r:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
    lines += ["ENDMDL\n", "ATOM      1 C    XXX     1       0.0     0.0"
              "     0.0\n"]
    path.write_text("".join(lines))


def _same_top(a, b):
    assert (a.names, a.types, a.resids, a.resnames, a.title) == (
        b.names, b.types, b.resids, b.resnames, b.title)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert a.positions.dtype == b.positions.dtype
    if a.box is None:
        assert b.box is None
    else:
        np.testing.assert_array_equal(a.box, b.box)


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return (1.0 + np.cumsum(rng.normal(0.0, 0.01, (n, 22, 3)), axis=0)
            ).astype(np.float32)


@pytest.mark.parametrize("expr", [
    "all", "type C", "type C or type O or type N", "name CA",
    "resname ALA", "resid 2", "resid 1:2", "index 3:10", "not type H",
    "(type C or type N) and resid 2", "not (resname ACE or resname NME)",
    "name C O and not resid 3", "type c",
])
def test_selection_matches_jax(expr):
    t, j = _topology(tio), _topology(jio)
    got, want = t.select_atoms(expr), j.select_atoms(expr)
    np.testing.assert_array_equal(got.ix, want.ix)
    assert got.ix.dtype == want.ix.dtype
    assert (got.names, got.types, got.resids) == (want.names, want.types,
                                                  want.resids)
    np.testing.assert_array_equal(got.positions, want.positions)
    heavy = t.select_atoms("not type H")
    assert got.indices_within(t.atoms) == want.indices_within(j.atoms)
    if set(got.ix) <= set(heavy.ix):
        assert got.indices_within(heavy) == want.indices_within(
            j.select_atoms("not type H"))


@pytest.mark.parametrize("expr", ["foo", "(type C", "type C )", "resid",
                                  "not"])
def test_selection_errors_match_jax(expr):
    with pytest.raises(ValueError) as t_err:
        _topology(tio).select_atoms(expr)
    with pytest.raises(ValueError) as j_err:
        _topology(jio).select_atoms(expr)
    assert str(t_err.value) == str(j_err.value)


def test_gro_pdb_dcd_files_match_jax(tmp_path):
    for box in ((2.5251, 2.7648, 2.3021), None):
        tg, jg = tmp_path / "t.gro", tmp_path / "j.gro"
        tio.write_gro(str(tg), _topology(tio, box=box))
        jio.write_gro(str(jg), _topology(jio, box=box))
        assert tg.read_bytes() == jg.read_bytes()
        _same_top(tio.parse_gro(str(jg)), jio.parse_gro(str(jg)))
    pdb = tmp_path / "t.pdb"
    _pdb(pdb, _topology(tio))
    _same_top(tio.parse_pdb(str(pdb)), jio.parse_pdb(str(pdb)))
    x = _frames(9, seed=1)
    td, jd = str(tmp_path / "t.dcd"), str(tmp_path / "j.dcd")
    tio.write_dcd(td, x, dt_ps=2.0, step_interval=3)
    jio.write_dcd(jd, x, dt_ps=2.0, step_interval=3)
    assert open(td, "rb").read() == open(jd, "rb").read()
    (tc, tdt), (jc, jdt) = tio.read_dcd(jd), jio.read_dcd(jd)
    assert tc.tobytes() == jc.tobytes() and tdt == jdt


def _universe_files(tmp_path):
    """One restart chain in every format Universe reads (h5md aside)."""
    parts = [_frames(n, seed=s) for n, s in ((8, 2), (5, 3), (6, 4),
                                              (4, 5), (3, 6))]
    f = {k: str(tmp_path / f"run.{k}")
         for k in ("xtc", "trr", "dcd", "nc", "lammpstrj")}
    jxtc.write_xtc(f["xtc"], parts[0], dt_ps=10.0)
    jtrr.write_trr(f["trr"], parts[1], dt_ps=10.0)
    jio.write_dcd(f["dcd"], parts[2], dt_ps=10.0)
    jnc.write_netcdf(f["nc"], parts[3], dt_ps=10.0)
    jlmp.write_lammpstrj(f["lammpstrj"], parts[4], length_scale=10.0)
    return f


def _same_universe(t, j):
    assert repr(t) == repr(j)
    ta, ja = t.trajectory, j.trajectory
    assert (ta.n_frames, ta.dt) == (ja.n_frames, ja.dt)
    assert ta.timeseries().tobytes() == ja.timeseries().tobytes()
    if ja.segment_starts is None:
        assert ta.segment_starts is None
    else:
        np.testing.assert_array_equal(ta.segment_starts, ja.segment_starts)
    assert t.box == j.box
    np.testing.assert_array_equal(t.atoms.ix, j.atoms.ix)


@pytest.mark.parametrize("case", [
    "gro only", "pdb only", "xtc", "trr", "dcd", "nc", "lammpstrj",
    "lammpstrj dt_ps", "xtc list", "mixed list", "mixed list dt_ps",
])
def test_universe_matches_jax(case, tmp_path):
    gro = tmp_path / "top.gro"
    jio.write_gro(str(gro), _topology(jio))
    top = str(gro)
    files = _universe_files(tmp_path)
    if case == "pdb only":
        top = str(tmp_path / "top.pdb")
        _pdb(tmp_path / "top.pdb", _topology(tio))
    traj, kw = None, {}
    if case in files:
        traj = files[case]
    elif case == "lammpstrj dt_ps":
        traj, kw = files["lammpstrj"], dict(dt_ps=0.5)
    elif case == "xtc list":
        extra = str(tmp_path / "run2.xtc")
        jxtc.write_xtc(extra, _frames(7, seed=9), dt_ps=10.0, t0_ps=80.0)
        traj = [files["xtc"], extra]
    elif case.startswith("mixed list"):
        # the LAMMPS dump has no timing and does not vote on the spacing
        traj = [files[k] for k in ("xtc", "trr", "dcd", "nc", "lammpstrj")]
        if case.endswith("dt_ps"):
            kw = dict(dt_ps=2.5)
    _same_universe(tio.Universe(top, traj, **kw),
                   jio.Universe(top, traj, **kw))


@pytest.mark.parametrize("case", ["spacing", "atoms", "format", "empty",
                                  "order"])
def test_universe_errors_match_jax(case, tmp_path):
    gro = str(tmp_path / "top.gro")
    jio.write_gro(gro, _topology(jio))
    x = _frames(4, seed=7)
    a, b = str(tmp_path / "a.xtc"), str(tmp_path / "b.xtc")
    jxtc.write_xtc(a, x, dt_ps=10.0)
    jxtc.write_xtc(b, x, dt_ps=20.0)
    bad = str(tmp_path / "bad.dcd")
    jio.write_dcd(bad, np.zeros((2, 5, 3), np.float32))
    args = {"spacing": (gro, [a, b]), "atoms": (gro, bad),
            "format": (gro, str(tmp_path / "t.pdb")), "empty": (gro, []),
            "order": (gro, a)}[case]
    errors = []
    for mod in (tio, jio):
        with pytest.raises(ValueError) as err:
            u = mod.Universe(*args)
            u.trajectory.timeseries(order="afc")
        errors.append(str(err.value))
    assert errors[0] == errors[1]
