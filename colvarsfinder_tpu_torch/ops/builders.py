"""Topology-driven feature builders.

Copied from ``colvarsfinder_tpu/ops/builders.py``: host-side numpy,
the imports adapted to the port.

The reference workflow constructs molann ``Feature`` objects by hand from
MDAnalysis selections (reference: examples/dipeptide/main.ipynb cell 10 —
two manually-typed dihedral atom quadruples). These helpers generate the
standard feature sets automatically from any AtomGroup-like object
(this framework's :class:`~colvarsfinder_tpu_torch.utils.io.AtomGroup` or an
MDAnalysis one — anything with ``.ix`` / ``.names`` / ``.resids`` and,
for distance cutoffs, ``.positions``):

* :func:`backbone_dihedrals` — all φ/ψ torsions from backbone N/CA/C
  atom names (the Ramachandran coordinates).
* :func:`heavy_atom_contacts` — hydrogen-filtered contact pairs within
  a reference-structure cutoff, as per-pair ``contact`` features or one
  pooled ``coordination`` feature (RATIONAL switching; see
  :mod:`colvarsfinder_tpu_torch.ops.features`).

Returned features carry GLOBAL topology indices: pass the training atom
selection as ``FeatureLayer(feats, input_ag=selection)`` and the layer
remaps them to input columns (molann semantics).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .features import Feature

__all__ = ["backbone_dihedrals", "heavy_atom_contacts"]

_BACKBONE = ("N", "CA", "C")


def _element(name: str) -> str:
    """Element guess from an atom name (MDAnalysis convention: first
    alphabetic character after stripping leading digits)."""
    s = str(name).strip().lstrip("0123456789")
    return s[0].upper() if s else ""


def backbone_dihedrals(ag, kind: str = "dihedral") -> List[Feature]:
    """All protein backbone φ/ψ torsion features found in ``ag``.

    φ(i) = C(i-1)–N(i)–CA(i)–C(i), ψ(i) = N(i)–CA(i)–C(i)–N(i+1); a
    torsion is emitted whenever both residues are present in the group
    and carry the needed backbone atoms (non-amino-acid residues such as
    waters or ligands simply lack N/CA/C names and are skipped).

    Args:
        ag: AtomGroup-like with ``.ix`` (global indices), ``.names``,
            ``.resids``.
        kind: ``'dihedral'`` ((cos, sin) features, the NN-input default)
            or ``'dihedral_rad'`` (radians).

    Returns:
        Features named ``phi_<resid>`` / ``psi_<resid>``, in residue
        order, with global atom indices.
    """
    if kind not in ("dihedral", "dihedral_rad"):
        raise ValueError(f"kind must be 'dihedral[_rad]', got {kind!r}")
    by_res: dict = {}
    for name, resid, gix in zip(ag.names, ag.resids, np.asarray(ag.ix)):
        if name in _BACKBONE:
            slot = by_res.setdefault(int(resid), {})
            if name not in slot:  # first occurrence wins (altlocs etc.)
                slot[name] = int(gix)
    feats: List[Feature] = []
    for r in sorted(by_res):
        cur = by_res[r]
        if any(k not in cur for k in _BACKBONE):
            continue
        prev = by_res.get(r - 1)
        if prev and "C" in prev:
            feats.append(
                Feature(
                    f"phi_{r}", kind,
                    (prev["C"], cur["N"], cur["CA"], cur["C"]),
                )
            )
        nxt = by_res.get(r + 1)
        if nxt and "N" in nxt:
            feats.append(
                Feature(
                    f"psi_{r}", kind,
                    (cur["N"], cur["CA"], cur["C"], nxt["N"]),
                )
            )
    if not feats:
        raise ValueError(
            "no backbone dihedrals found (the group has no consecutive "
            "residues with N/CA/C atoms)"
        )
    return feats


def heavy_atom_contacts(
    group_a,
    group_b=None,
    *,
    r0: float = 0.45,
    d0: float = 0.0,
    nn: int = 6,
    mm: Optional[int] = None,
    cutoff: Optional[float] = None,
    min_resid_sep: Optional[int] = 2,
    as_coordination: bool = False,
) -> List[Feature]:
    """Hydrogen-filtered contact features between (or within) atom groups.

    Args:
        group_a: AtomGroup-like. With ``group_b=None`` all within-group
            pairs i < j are considered; otherwise all cross pairs.
        group_b: optional second group.
        r0, d0, nn, mm: RATIONAL switching parameters, in the trajectory
            length unit (``mm`` defaults to ``2*nn``). The default
            r0 = 0.45 nm is the common heavy-atom native-contact radius.
        cutoff: keep only pairs closer than this in the groups'
            REFERENCE positions (``.positions``, e.g. the topology
            frame) — the standard native-contact definition. None keeps
            every pair.
        min_resid_sep: drop pairs fewer than this many residues apart
            (trivially-always-formed neighbors); None disables.
        as_coordination: pool all pairs into ONE ``coordination``
            feature (the contact count) instead of per-pair ``contact``
            features.

    Returns:
        list of Features with global atom indices (length 1 when
        ``as_coordination``).
    """
    params = {"r0": r0, "d0": d0, "nn": nn}
    if mm is not None:
        params["mm"] = mm
    intra = group_b is None
    gb_src = group_a if intra else group_b

    def _heavy(ag):
        pos = None
        if cutoff is not None:
            pos = np.asarray(ag.positions, dtype=np.float64)
        out = []
        for j, (name, resid, gix) in enumerate(
            zip(ag.names, ag.resids, np.asarray(ag.ix))
        ):
            if _element(name) == "H":
                continue
            out.append(
                (int(gix), int(resid), None if pos is None else pos[j])
            )
        return out

    ha, hb = _heavy(group_a), _heavy(gb_src)
    pairs = []
    for (ga, ra, pa) in ha:
        for (gb, rb, pb) in hb:
            if intra and gb <= ga:
                continue
            if ga == gb:
                continue
            if min_resid_sep is not None and abs(ra - rb) < min_resid_sep:
                continue
            if cutoff is not None and np.linalg.norm(pa - pb) > cutoff:
                continue
            pairs.append((ga, gb))
    if not pairs:
        raise ValueError(
            "no contact pairs survived the filters (heavy atoms, "
            f"min_resid_sep={min_resid_sep}, cutoff={cutoff})"
        )
    if as_coordination:
        flat = tuple(i for p in pairs for i in p)
        return [Feature("n_contacts", "coordination", flat, params)]
    return [
        Feature(f"contact_{ga}_{gb}", "contact", (ga, gb), params)
        for ga, gb in pairs
    ]
