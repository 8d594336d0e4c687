"""PLUMED deployment: emit PLUMED input files that bias MD along a trained CV.

Copied from the JAX package's ``colvarsfinder_tpu/deploy_plumed.py``, which
is numpy-only apart from ``build_torch_cv``; here that function is the
port's :func:`.deploy_torch.build_torch_cv`, and both packages write the
same ``plumed.dat`` text for one saved CV.

* :func:`write_plumed_cv` converts a saved numpy-CV artifact
  (:func:`.deploy.save_numpy_cv`, written by ``task.save_model()``) into (a)
  a TorchScript model consumable by PLUMED's ``PYTORCH_MODEL`` action and
  (b) the PLUMED input lines that compute the model's inputs with native
  PLUMED actions (``TORSION`` / ``ANGLE`` / ``DISTANCE`` / ``COORDINATION``
  / ``POSITION``) and wire them into the model.
* :func:`write_plumed_metad` appends a well-tempered ``METAD`` action along
  the CV components plus a ``PRINT`` line, producing a complete, runnable
  ``plumed.dat``.

The readers of PLUMED's HILLS and COLVAR files that close the adaptive loop
are :func:`.utils.enhanced.read_plumed_hills` and
:func:`.utils.enhanced.read_plumed_colvar`, and
:func:`.utils.enhanced.metad_frame_weights` turns them into training
weights.

Two emission modes, chosen automatically from the artifact's graph:

``features``
    The preprocessing layer is a pure feature map (bond / angle / dihedral
    features, no alignment, no raw positions). Each feature scalar becomes a
    native PLUMED action (the convention of the mlcolvar / Deep-TICA
    ecosystem) and only the trained head is exported to TorchScript.
    PLUMED's conventions coincide with this package's: ``ANGLE`` is the
    bend at the middle atom in radians (our ``angle_rad``; the cosine-valued
    ``angle`` feature gets a ``CUSTOM FUNC=cos(x)`` wrapper), ``TORSION`` is
    the standard IUPAC dihedral (our ``dihedral_rad``; the (cos, sin)-valued
    ``dihedral`` feature gets two ``CUSTOM`` wrappers), ``DISTANCE`` is our
    ``bond``, and ``COORDINATION`` with a ``RATIONAL`` switch is our
    ``contact`` / ``coordination`` (the pair list maps to
    ``GROUPA``/``GROUPB`` with ``PAIR``; R_0/D_0 are re-expressed in
    PLUMED's nm so the switching value is unit-invariant).

``positions``
    The graph needs raw coordinates (an alignment layer and/or ``position``
    features). Every input atom's coordinates are exposed with ``POSITION``
    actions and the FULL graph (alignment included: it is differentiable,
    so PLUMED's autograd force path goes through it; no ``FIT_TO_TEMPLATE``
    needed) runs inside the TorchScript model.

Units: PLUMED uses nm / kJ/mol / ps. A CV trained on MDAnalysis-loaded
coordinates (Angstrom) needs ``length_scale=10.0``, which rescales
distances / raw coordinates before they enter the model (angles and
dihedrals are scale-free).

PLUMED's ``PYTORCH_MODEL`` action (the ``pytorch`` module, PLUMED >= 2.9)
feeds the model a ``[1, n_args]`` float32 tensor with ``requires_grad`` and
reads back ``[1, n_out]``, exposing components ``label.node-0`` ...
``label.node-{n_out-1}``; the writers here follow that contract.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np

__all__ = [
    "PlumedCV",
    "write_plumed_cv",
    "write_plumed_metad",
]

CV_DAT_NAME = "plumed_cv.dat"
METAD_DAT_NAME = "plumed.dat"
MODEL_NAME = "plumed_cv_model.pt"


@dataclasses.dataclass
class PlumedCV:
    """What :func:`write_plumed_cv` produced.

    Attributes:
        dat_path: the PLUMED input fragment defining the CV
        model_path: the TorchScript model ``PYTORCH_MODEL`` loads
        label: PLUMED label of the model action
        components: full component names to bias / print
            (``['cv.node-0', 'cv.node-1']``)
        arg_names: labels of the PLUMED actions feeding the model, in input
            order
        mode: ``'features'`` or ``'positions'``
        lines: the emitted PLUMED lines (without the trailing newline each)
    """

    dat_path: str
    model_path: str
    label: str
    components: list
    arg_names: list
    mode: str
    lines: list


def _flatten(node: dict, out: list) -> None:
    if node["kind"] == "compose":
        for s in node["stages"]:
            _flatten(s, out)
    elif node["kind"] != "identity":
        out.append(node)


def _load_artifact(artifact_dir: str):
    import json

    from .deploy import FORMAT, PARAMS_NAME, SPEC_NAME

    with open(os.path.join(artifact_dir, SPEC_NAME)) as f:
        spec = json.load(f)
    if spec.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact: {spec.get('format')!r}")
    with np.load(os.path.join(artifact_dir, PARAMS_NAME)) as data:
        params = {k: data[k] for k in data.files}
    return spec, params


def _global_atom_numbers(
    relative_indices: Sequence[int],
    atoms: Optional[Sequence[int]],
) -> list:
    """Map model-input atom indices (0-based, relative to the training atom
    selection) to 1-based PLUMED serials via the ``atoms`` selection."""
    if atoms is None:
        return [int(i) + 1 for i in relative_indices]
    ix = getattr(atoms, "ix", atoms)
    ix = np.asarray(ix).reshape(-1)
    try:
        return [int(ix[int(i)]) + 1 for i in relative_indices]
    except IndexError:
        raise ValueError(
            f"feature atom index {max(int(i) for i in relative_indices)} is "
            f"out of range for the {len(ix)}-atom `atoms` selection"
        )


def _feature_lines(
    features: list,
    atoms: Optional[Sequence[int]],
    length_scale: float,
    pbc: bool = False,
):
    """PLUMED action lines for every feature scalar, in the exact order
    the FeatureLayer concatenates them (ops/features.py `_eval_feature`).

    ``pbc=True`` (the FeatureLayer carried a minimum-image box): the
    pair-DISTANCE-type actions (DISTANCE / COORDINATION) are emitted
    WITHOUT ``NOPBC`` so PLUMED applies the engine's live box — the same
    convention the training-side features used. Angles/torsions stay
    NOPBC either way (bonded atoms; molecules are made whole upstream)."""
    dist_pbc = "" if pbc else " NOPBC"
    lines: list = []
    args: list = []
    for fi, feat in enumerate(features):
        ftype = feat["type"]
        serials = _global_atom_numbers(feat["atom_indices"], atoms)
        alist = ",".join(str(s) for s in serials)
        base = f"cvf{fi}"
        if ftype == "bond":
            if length_scale != 1.0:
                lines.append(f"{base}_nm: DISTANCE ATOMS={alist}{dist_pbc}")
                lines.append(
                    f"{base}: CUSTOM ARG={base}_nm "
                    f"FUNC=x*{length_scale:g} PERIODIC=NO"
                )
            else:
                lines.append(f"{base}: DISTANCE ATOMS={alist}{dist_pbc}")
            args.append(base)
        elif ftype == "angle_rad":
            lines.append(f"{base}: ANGLE ATOMS={alist} NOPBC")
            args.append(base)
        elif ftype == "angle":
            lines.append(f"{base}_t: ANGLE ATOMS={alist} NOPBC")
            lines.append(
                f"{base}: CUSTOM ARG={base}_t FUNC=cos(x) PERIODIC=NO"
            )
            args.append(base)
        elif ftype == "dihedral_rad":
            lines.append(f"{base}: TORSION ATOMS={alist} NOPBC")
            args.append(base)
        elif ftype == "dihedral":
            lines.append(f"{base}_t: TORSION ATOMS={alist} NOPBC")
            lines.append(
                f"{base}_cos: CUSTOM ARG={base}_t FUNC=cos(x) PERIODIC=NO"
            )
            lines.append(
                f"{base}_sin: CUSTOM ARG={base}_t FUNC=sin(x) PERIODIC=NO"
            )
            args.extend([f"{base}_cos", f"{base}_sin"])
        elif ftype in ("contact", "coordination"):
            # s depends only on (r - d0)/r0, so expressing R_0/D_0 in
            # PLUMED's nm (dividing by length_scale) makes the switching
            # value unit-invariant — no CUSTOM wrapper needed.
            sw = feat["params"]
            switch = (
                f"{{RATIONAL R_0={sw['r0'] / length_scale:.10g} "
                f"D_0={sw['d0'] / length_scale:.10g} "
                f"NN={int(sw['nn'])} MM={int(sw['mm'])}}}"
            )
            ga = ",".join(str(s) for s in serials[0::2])
            gb = ",".join(str(s) for s in serials[1::2])
            pair = " PAIR" if ftype == "coordination" else ""
            lines.append(
                f"{base}: COORDINATION GROUPA={ga} GROUPB={gb}{pair} "
                f"SWITCH={switch}{dist_pbc}"
            )
            args.append(base)
        else:  # position features force positions mode upstream
            raise AssertionError(f"unexpected feature type {ftype!r}")
    return lines, args


def _n_input_atoms(flat_nodes: list) -> int:
    """Smallest atom count consistent with the graph (max index + 1)."""
    hi = -1
    for node in flat_nodes:
        if node["kind"] == "alignment":
            hi = max(hi, max(int(i) for i in node["align_idx"]))
        elif node["kind"] == "features":
            for feat in node["features"]:
                hi = max(hi, max(int(i) for i in feat["atom_indices"]))
    if hi < 0:
        raise ValueError(
            "cannot infer the input atom count from the CV graph "
            "(no alignment or feature atom indices); pass n_atoms="
        )
    return hi + 1


def _head_module(spec: dict, params: dict, head_nodes: list):
    from .deploy_torch import build_torch_cv

    head_spec = {
        "state_ndim": 1,
        "graph": {"kind": "compose", "stages": head_nodes},
    }
    return build_torch_cv(head_spec, params)


def _positions_module(spec: dict, params: dict, n_atoms: int, scale: float):
    import torch

    from .deploy_torch import build_torch_cv

    net = build_torch_cv(spec, params)

    class _FlatPositionsCV(torch.nn.Module):
        """[B, 3N] (or [3N]) flattened nm coordinates -> CV values."""

        def __init__(self):
            super().__init__()
            self.net = net
            self.n_atoms: int = n_atoms
            self.scale: float = float(scale)

        def forward(self, x):
            if x.dim() == 1:
                x = x.unsqueeze(0)
            y = (x * self.scale).view(x.shape[0], self.n_atoms, 3)
            return self.net(y)

    return _FlatPositionsCV()


def _n_outputs(flat_nodes: list, params: dict) -> int:
    """Output dimension of the CV graph (last parametric node's fan-out)."""
    for node in reversed(flat_nodes):
        if node["kind"] == "mlp":
            w = params[node["layers"][-1][0]]  # [d_out, d_in]
            return int(w.shape[0])
        if node["kind"] == "stacked_mlp":
            w = params[node["layers"][-1][0]]  # [k, d_out, d_in]
            return int(w.shape[0] * w.shape[1])
        if node["kind"] == "features":
            # contact/coordination are width-1 like bond/angle
            return sum(
                3 * len(f["atom_indices"])
                if f["type"] == "position"
                else (2 if f["type"] == "dihedral" else 1)
                for f in node["features"]
            )
    raise ValueError("cannot determine the CV output dimension")


def write_plumed_cv(
    artifact_dir: str,
    out_dir: Optional[str] = None,
    *,
    label: str = "cv",
    atoms: Optional[Sequence[int]] = None,
    n_atoms: Optional[int] = None,
    length_scale: float = 1.0,
    mode: Optional[str] = None,
) -> PlumedCV:
    """Emit the PLUMED definition of a saved CV (fragment + TorchScript).

    Args:
        artifact_dir: directory holding ``cv_numpy_spec.json`` +
            ``cv_numpy.npz`` (written by ``task.save_model()`` /
            :func:`.deploy.save_numpy_cv`).
        out_dir: where to write ``plumed_cv.dat`` and
            ``plumed_cv_model.pt`` (default: ``artifact_dir``).
        label: PLUMED label for the ``PYTORCH_MODEL`` action.
        atoms: the training atom selection as GLOBAL 0-based topology
            indices (an MDAnalysis-style AtomGroup with ``.ix`` is
            accepted). Feature/alignment atom indices in the artifact are
            relative to this selection; PLUMED serials are global and
            1-based. Omit when the model input already spans the whole
            topology in order.
        n_atoms: input atom count for positions mode (default: inferred as
            the largest referenced index + 1).
        length_scale: factor from PLUMED's nm to the model's training
            length unit, applied to distances / raw coordinates before the
            model (``10.0`` for Angstrom-trained CVs; angles and dihedrals
            are scale-free). Default 1.0 = trained in nm (this framework's
            native convention).
        mode: force ``'features'`` or ``'positions'``; default picks
            ``'features'`` whenever the graph allows it.

    Returns:
        a :class:`PlumedCV` with paths, the model label, and the component
        names to bias (``label.node-i``).
    """
    import torch

    spec, params = _load_artifact(artifact_dir)
    out_dir = artifact_dir if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)

    flat: list = []
    _flatten(spec["graph"], flat)

    has_alignment = any(n["kind"] == "alignment" for n in flat)
    feat_nodes = [n for n in flat if n["kind"] == "features"]
    has_position_feature = any(
        f["type"] == "position" for n in feat_nodes for f in n["features"]
    )
    features_ok = (
        len(feat_nodes) == 1
        and not has_alignment
        and not has_position_feature
        and flat
        and flat[0]["kind"] == "features"
    )
    if mode is None:
        mode = "features" if features_ok else "positions"
    elif mode not in ("features", "positions"):
        raise ValueError(
            f"mode must be 'features' or 'positions', got {mode!r}"
        )
    elif mode == "features" and not features_ok:
        raise ValueError(
            "mode='features' needs a pure feature-map preprocessing layer "
            "(no alignment, no position features) as the first graph stage"
        )

    model_path = os.path.join(out_dir, MODEL_NAME)
    if mode == "features":
        lines, args = _feature_lines(
            feat_nodes[0]["features"], atoms, length_scale,
            pbc=feat_nodes[0].get("box") is not None,
        )
        module = _head_module(spec, params, flat[1:])
    else:
        if int(spec.get("state_ndim", 1)) != 2:
            raise ValueError(
                "positions mode needs a coordinate-input CV "
                "(state_ndim == 2, i.e. [N, 3] states)"
            )
        na = _n_input_atoms(flat) if n_atoms is None else int(n_atoms)
        serials = _global_atom_numbers(range(na), atoms)
        lines = [
            f"cvp{i}: POSITION ATOM={s} NOPBC" for i, s in enumerate(serials)
        ]
        args = [
            f"cvp{i}.{c}" for i in range(na) for c in ("x", "y", "z")
        ]
        module = _positions_module(spec, params, na, length_scale)

    scripted = torch.jit.script(module)
    scripted.save(model_path)

    lines.append(
        f"{label}: PYTORCH_MODEL FILE={os.path.basename(model_path)} "
        f"ARG={','.join(args)}"
    )
    n_out = _n_outputs(flat, params)
    components = [f"{label}.node-{i}" for i in range(n_out)]

    header = [
        "# Collective variable exported by colvarsfinder-tpu",
        f"# mode={mode}  components={','.join(components)}",
        "# PLUMED units assumed: nm, kJ/mol, ps (PLUMED defaults)",
    ]
    dat_path = os.path.join(out_dir, CV_DAT_NAME)
    with open(dat_path, "w") as f:
        f.write("\n".join(header + lines) + "\n")

    return PlumedCV(
        dat_path=dat_path,
        model_path=model_path,
        label=label,
        components=components,
        arg_names=args,
        mode=mode,
        lines=lines,
    )


def write_plumed_metad(
    artifact_dir: str,
    out_dir: Optional[str] = None,
    *,
    sigma,
    height: float,
    pace: int = 500,
    biasfactor: Optional[float] = None,
    temp: Optional[float] = None,
    grid_min=None,
    grid_max=None,
    grid_bin=None,
    hills_file: str = "HILLS",
    colvar_file: str = "COLVAR",
    print_stride: int = 100,
    extra_lines: Sequence[str] = (),
    **cv_kwargs: Any,
) -> PlumedCV:
    """Write a complete ``plumed.dat`` running well-tempered metadynamics
    along the saved CV.

    The resulting HILLS / COLVAR files are those that
    :func:`.utils.enhanced.read_plumed_hills` /
    :func:`.utils.enhanced.read_plumed_colvar` and
    :func:`.utils.enhanced.metad_frame_weights` read back for retraining.

    Args:
        artifact_dir, **cv_kwargs: forwarded to :func:`write_plumed_cv`.
        sigma: Gaussian width per CV component (scalar or one per
            component), in CV units.
        height: Gaussian height in the engine's energy units (kJ/mol for
            GROMACS); for well-tempered runs this is the INITIAL height —
            PLUMED rescales deposited heights itself.
        pace: deposition stride in MD steps.
        biasfactor: well-tempered bias factor gamma (omit for standard
            metadynamics). Requires ``temp``.
        temp: system temperature in K (required with ``biasfactor``).
        grid_min, grid_max, grid_bin: optional METAD grid (scalar or one
            value per component each); strongly recommended for long runs.
        hills_file: HILLS output path (PLUMED ``FILE=``).
        colvar_file: PRINT output path.
        print_stride: PRINT stride in MD steps.
        extra_lines: verbatim PLUMED lines appended before PRINT (walls,
            extra monitors, ...).

    Returns:
        the :class:`PlumedCV` (its ``dat_path`` now points at the full
        ``plumed.dat``).
    """
    out_dir = artifact_dir if out_dir is None else out_dir
    cv = write_plumed_cv(artifact_dir, out_dir, **cv_kwargs)
    k = len(cv.components)

    def _per_component(val, name):
        arr = np.asarray(val, dtype=float).reshape(-1)
        if arr.size == 1:
            arr = np.repeat(arr, k)
        if arr.size != k:
            raise ValueError(
                f"{name} needs 1 or {k} values, got {arr.size}"
            )
        return ",".join(f"{v:g}" for v in arr)

    metad = [
        "metad: METAD ...",
        f"  ARG={','.join(cv.components)}",
        f"  SIGMA={_per_component(sigma, 'sigma')}",
        f"  HEIGHT={float(height):g} PACE={int(pace)}",
        f"  FILE={hills_file}",
    ]
    if biasfactor is not None:
        if temp is None:
            raise ValueError(
                "well-tempered metadynamics (biasfactor=) needs temp= "
                "(PLUMED requires TEMP unless the engine provides it)"
            )
        metad.append(f"  BIASFACTOR={float(biasfactor):g} TEMP={float(temp):g}")
    if grid_min is not None or grid_max is not None:
        if grid_min is None or grid_max is None:
            raise ValueError("grid_min and grid_max must be given together")
        metad.append(f"  GRID_MIN={_per_component(grid_min, 'grid_min')}")
        metad.append(f"  GRID_MAX={_per_component(grid_max, 'grid_max')}")
        if grid_bin is not None:
            metad.append(f"  GRID_BIN={_per_component(grid_bin, 'grid_bin')}")
    metad.append("... METAD")

    print_line = (
        f"PRINT ARG={','.join(cv.components)},metad.bias "
        f"STRIDE={int(print_stride)} FILE={colvar_file}"
    )

    dat_path = os.path.join(out_dir, METAD_DAT_NAME)
    with open(cv.dat_path) as f:
        cv_text = f.read().rstrip("\n")
    body = [cv_text, ""] + metad + [""]
    body.extend(str(ln) for ln in extra_lines)
    body.append(print_line)
    with open(dat_path, "w") as f:
        f.write("\n".join(body) + "\n")

    # plumed.dat is self-contained; the plumed_cv.dat fragment remains on
    # disk for users composing their own biasing schemes around the CV
    cv.dat_path = dat_path
    return cv
