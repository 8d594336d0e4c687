"""Native (C++) CV program writer: ``cv_native.bin``.

Copied from the writer half of the JAX package's
``colvarsfinder_tpu/deploy_native.py`` (``:61-171``): a pure ``struct``
re-encoding of the numpy artifact (:mod:`.deploy`) as the flat binary
program that ``native/cveval.cpp`` evaluates, values and input Jacobian,
through a plain C API an MD-engine plugin calls directly. Both packages
write byte-identical programs for one CV. The loader that builds and calls
``native/cveval.cpp`` is not ported yet (ROADMAP.md queue 1, item 12).

Binary format ``CVNATV02`` (little-endian, f64 params)::

    magic[8] = "CVNATV02"
    i32 state_ndim              (1 = feature vector, 2 = [N, 3] coordinates)
    i32 n_params
    per param: i32 ndim, i32 dims[ndim], f64 data[prod(dims)]
    i32 n_ops
    per op: i32 kind, payload --
      kind 0 ALIGNMENT:   i32 ref_param, i32 weight_param (-1 none),
                          i32 m, i32 idx[m]
      kind 1 FEATURES:    i32 n_features, i32 has_box, [has_box: f64 box[3]],
                          per feature: i32 ftype,
                          i32 n_idx, i32 idx[n_idx],
                          [ftype >= 6 only: f64 r0, f64 d0, i32 nn, i32 mm]
                          (ftype: 0 position, 1 bond, 2 angle, 3 angle_rad,
                           4 dihedral, 5 dihedral_rad, 6 contact,
                           7 coordination)
      kind 2 MLP:         i32 act, i32 n_layers,
                          per layer: i32 w_param, i32 b_param
      kind 3 STACKED_MLP: i32 act, i32 k, i32 n_layers,
                          per layer: i32 w_param, i32 b_param
    (act: 0 tanh, 1 relu, 2 elu, 3 gelu, 4 sigmoid, 5 softplus, 6 celu,
     7 identity; ``identity`` graph nodes are dropped, ``compose`` nodes
     are flattened: the graph is always a linear pipeline)
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

__all__ = ["NATIVE_NAME", "write_native_cv"]

MAGIC = b"CVNATV02"
NATIVE_NAME = "cv_native.bin"

_FTYPE = {
    "position": 0, "bond": 1, "angle": 2, "angle_rad": 3,
    "dihedral": 4, "dihedral_rad": 5, "contact": 6, "coordination": 7,
}
_ACT = {
    "tanh": 0, "tanh_native": 0, "relu": 1, "elu": 2, "gelu": 3,
    "sigmoid": 4, "softplus": 5, "celu": 6, "identity": 7,
}


# ---------------------------------------------------------------------------
# writer: spec graph -> flat binary program
# ---------------------------------------------------------------------------


def _flatten_graph(node: dict, out: list) -> None:
    kind = node["kind"]
    if kind == "identity":
        return
    if kind == "compose":
        for stage in node["stages"]:
            _flatten_graph(stage, out)
        return
    out.append(node)


def write_native_cv(out_dir: str) -> str:
    """Convert a saved numpy-CV artifact (spec + npz) in ``out_dir`` into
    the native binary program ``cv_native.bin``. Returns its path."""
    from .deploy import FORMAT, PARAMS_NAME, SPEC_NAME

    with open(os.path.join(out_dir, SPEC_NAME)) as f:
        spec = json.load(f)
    if spec.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact")
    with np.load(os.path.join(out_dir, PARAMS_NAME)) as data:
        params = {k: np.asarray(data[k], dtype=np.float64) for k in data.files}

    nodes: list = []
    _flatten_graph(spec["graph"], nodes)

    # collect parameters in first-use order
    pidx: dict[str, int] = {}
    plist: list[np.ndarray] = []

    def use(name: str) -> int:
        if name not in pidx:
            pidx[name] = len(plist)
            plist.append(params[name])
        return pidx[name]

    ops = bytearray()
    for node in nodes:
        kind = node["kind"]
        if kind == "alignment":
            ref_p = use(node["ref"])
            w_p = use(node["weights"]) if "weights" in node else -1
            idx = [int(i) for i in node["align_idx"]]
            ops += struct.pack(f"<4i{len(idx)}i", 0, ref_p, w_p, len(idx), *idx)
        elif kind == "features":
            feats = node["features"]
            ops += struct.pack("<2i", 1, len(feats))
            box = node.get("box")
            if box is not None:
                ops += struct.pack("<i3d", 1, *[float(v) for v in box])
            else:
                ops += struct.pack("<i", 0)
            for feat in feats:
                ai = [int(i) for i in np.atleast_1d(feat["atom_indices"])]
                ops += struct.pack(
                    f"<2i{len(ai)}i", _FTYPE[feat["type"]], len(ai), *ai
                )
                if _FTYPE[feat["type"]] >= 6:
                    sw = feat["params"]
                    ops += struct.pack(
                        "<2d2i", float(sw["r0"]), float(sw["d0"]),
                        int(sw["nn"]), int(sw["mm"]),
                    )
        elif kind in ("mlp", "stacked_mlp"):
            layers = [(use(w), use(b)) for w, b in node["layers"]]
            act = _ACT[node["activation"]]
            if kind == "mlp":
                ops += struct.pack("<3i", 2, act, len(layers))
            else:
                k = plist[layers[0][0]].shape[0]
                ops += struct.pack("<4i", 3, act, k, len(layers))
            for w, b in layers:
                ops += struct.pack("<2i", w, b)
        else:
            raise ValueError(f"unknown spec node kind '{kind}'")

    blob = bytearray(MAGIC)
    blob += struct.pack("<2i", int(spec.get("state_ndim", 1)), len(plist))
    for arr in plist:
        blob += struct.pack(f"<i{arr.ndim}i", arr.ndim, *arr.shape)
        blob += np.ascontiguousarray(arr).tobytes()
    blob += struct.pack("<i", len(nodes))
    blob += ops
    path = os.path.join(out_dir, NATIVE_NAME)
    with open(path, "wb") as f:
        f.write(blob)
    return path
