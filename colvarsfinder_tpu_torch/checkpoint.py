r"""Checkpoints of the port: PyTorch state dicts, per-CV text dumps, the
full training state (model, optimizer moments, epoch), and the migration
to and from the original colvarsfinder's ``model.pt`` state dicts.

Counterpart of what ``TrainingTask.save_model`` needs from
``colvarsfinder_tpu/checkpoint.py`` and ``core/task.py:867-941``, and of
that module's :func:`load_torch_state_dict` / :func:`save_torch_state_dict`
(``checkpoint.py:145-317``). The JAX package's pytree and Orbax
checkpoints have no counterpart here: a port model is a ``torch.nn.Module``
whose state dict is its checkpoint.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

__all__ = [
    "load_torch_state_dict",
    "load_training_state",
    "save_cv_text",
    "save_state_dict",
    "save_torch_state_dict",
    "save_training_state",
]


def save_state_dict(module: torch.nn.Module, filename: str) -> None:
    """``torch.save`` of the module's state dict."""
    torch.save(module.state_dict(), filename)


def save_cv_text(model, k: int, out_dir: str) -> None:
    """Per-CV plain-text parameter dumps ``<cv>_<layer>_<weight|bias>.txt``
    (the reference's format, ``colvarsfinder_tpu/core/task.py:889-896``)."""
    os.makedirs(out_dir, exist_ok=True)
    for idx in range(k):
        for name, param in model.get_params_of_cv(idx):
            fname = os.path.join(
                out_dir, f"{idx}_" + name.replace(".", "_") + ".txt"
            )
            arr = param.detach().cpu().numpy()
            np.savetxt(fname, np.atleast_1d(arr))


def save_training_state(filename: str, model, optimizer, epoch: int) -> None:
    """Model parameters, optimizer state and epoch in one file."""
    torch.save(
        {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "epoch": int(epoch),
        },
        filename,
    )


def load_training_state(filename: str, model, optimizer) -> int:
    """Restore model and optimizer state in place; returns the epoch."""
    state = torch.load(filename, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])


def load_torch_state_dict(model, source):
    """A new model of ``model``'s type and architecture carrying the
    parameters of an original colvarsfinder checkpoint (its ``model.pt``
    state dicts): the migration path for models trained with it
    (``colvarsfinder_tpu/checkpoint.py:145-236``).

    The original names each network's linear layers ``'1'``, ``'2'``, ...
    and keeps per-head networks in ``ModuleList`` containers; the port
    keeps the heads of :class:`..models.EigenFunctions` (and a
    :class:`..models.RegAutoEncoder`'s ``reg``) stacked, so
    ``eigen_funcs.{h}.{i+1}.weight`` becomes row ``h`` of ``weights.{i}``
    and ``reg.{h}.{i+1}.weight`` row ``h`` of ``reg.weights.{i}``;
    ``encoder.{i+1}.*``, ``decoder.{i+1}.*`` and a
    :class:`..models.Sequential`'s ``{i+1}.*`` keep their names.

    Args:
        model: a :class:`..models.Sequential`, :class:`..models.AutoEncoder`,
            :class:`..models.EigenFunctions` or
            :class:`..models.RegAutoEncoder` supplying the architecture,
            the activation, and the dtype and device of the result.
        source: a path to a state dict saved with ``torch.save`` (read
            with ``weights_only=True``), or a mapping of names to tensors
            or arrays.

    Returns:
        a new model of the same type with the checkpoint's parameters.
    """
    from .models.ae import AutoEncoder, RegAutoEncoder
    from .models.eigen import EigenFunctions
    from .models.module import Sequential

    if isinstance(source, (str, os.PathLike)):
        source = torch.load(source, map_location="cpu", weights_only=True)
    named = {k: torch.as_tensor(np.asarray(v.detach().cpu().numpy()
                                           if torch.is_tensor(v) else v))
             for k, v in source.items()}

    def seq(template: Sequential, prefix: str) -> Sequential:
        return Sequential([
            {n: named[f"{prefix}{i + 1}.{n}"].to(layer[n].device,
                                                 layer[n].dtype)
             for n in ("weight", "bias")}
            for i, layer in enumerate(template.params)
        ], template.activation)

    def stacked(template: EigenFunctions, prefix: str) -> EigenFunctions:
        w0 = template.weights[0]
        new = EigenFunctions(template.layer_dims, template.k,
                             template.activation, dtype=w0.dtype,
                             device=w0.device)
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(new.weights, new.biases)):
                for dst, n in ((w, "weight"), (b, "bias")):
                    dst.copy_(torch.stack([
                        named[f"{prefix}{h}.{i + 1}.{n}"]
                        for h in range(template.k)]))
        return new

    if isinstance(model, Sequential):
        return seq(model, "")
    if isinstance(model, EigenFunctions):
        # the original's torch.nn.ModuleList named 'eigen_funcs'
        return stacked(model, "eigen_funcs.")
    if isinstance(model, RegAutoEncoder):
        return RegAutoEncoder(
            encoder=seq(model.encoder, "encoder."),
            decoder=seq(model.decoder, "decoder."),
            reg=stacked(model.reg, "reg.") if model.num_reg > 0 else None)
    if isinstance(model, AutoEncoder):
        return AutoEncoder(encoder=seq(model.encoder, "encoder."),
                           decoder=seq(model.decoder, "decoder."))
    raise TypeError(
        f"unsupported model type {type(model).__name__} for torch "
        "state-dict migration"
    )


def save_torch_state_dict(model, filename=None) -> dict:
    """The original colvarsfinder's state dict of a port model, float32 on
    the CPU, named as the original names it, so that its
    ``load_state_dict(..., strict=True)`` takes it: the way back
    (``colvarsfinder_tpu/checkpoint.py:239-317``; the names as in
    :func:`load_torch_state_dict`).

    Args:
        model: a :class:`..models.Sequential`, :class:`..models.AutoEncoder`,
            :class:`..models.EigenFunctions` or
            :class:`..models.RegAutoEncoder`.
        filename: where to ``torch.save`` the dict (``model.pt``), if given.

    Returns:
        an ``OrderedDict`` of tensors.
    """
    from .models.ae import AutoEncoder, RegAutoEncoder
    from .models.eigen import EigenFunctions
    from .models.module import Sequential

    sd: dict = collections.OrderedDict()

    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32).clone()

    def put_seq(prefix: str, params) -> None:
        for i, layer in enumerate(params):
            sd[f"{prefix}{i + 1}.weight"] = f32(layer["weight"])
            sd[f"{prefix}{i + 1}.bias"] = f32(layer["bias"])

    def put_stacked(prefix: str, heads: EigenFunctions) -> None:
        for h in range(heads.k):
            put_seq(f"{prefix}{h}.", [{"weight": w[h], "bias": b[h]}
                                      for w, b in zip(heads.weights,
                                                      heads.biases)])

    if isinstance(model, Sequential):
        put_seq("", model.params)
    elif isinstance(model, EigenFunctions):
        put_stacked("eigen_funcs.", model)
    elif isinstance(model, (AutoEncoder, RegAutoEncoder)):
        put_seq("encoder.", model.encoder.params)
        put_seq("decoder.", model.decoder.params)
        if isinstance(model, RegAutoEncoder) and model.num_reg > 0:
            put_stacked("reg.", model.reg)
    else:
        raise TypeError(
            f"unsupported model type {type(model).__name__} for torch "
            "state-dict export"
        )
    if filename is not None:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        torch.save(sd, filename)
    return sd
