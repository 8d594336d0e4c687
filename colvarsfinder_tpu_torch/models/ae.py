r"""Autoencoder models (port of ``colvarsfinder_tpu/models/ae.py``).

The encoder and the decoder are :class:`.module.Sequential` networks. The
K regularizer heads of :class:`RegAutoEncoder` are one stacked ensemble,
an :class:`.eigen.EigenFunctions` on the latent space (weights
``[K, d_out, d_in]``, one batched product per layer), as the JAX
package's ``stacked_mlp_init`` / ``stacked_mlp_apply`` parameters are.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..config import default_dtype
from .eigen import EigenFunctions
from .module import Sequential, mlp_init

__all__ = ["AutoEncoder", "RegAutoEncoder", "RegModel"]


def _sequential(layer_dims, activation, generator) -> Sequential:
    return Sequential(mlp_init(layer_dims, generator=generator), activation)


def _sequential_from_numpy(params: Sequence[dict], activation) -> Sequential:
    """A :class:`Sequential` from the JAX pytree layout: per layer
    ``{'weight': [d_out, d_in], 'bias': [d_out]}`` as numpy arrays."""
    return Sequential(
        [{name: torch.tensor(np.asarray(layer[name]), dtype=default_dtype())
          for name in ("weight", "bias")} for layer in params],
        activation,
    )


def _check_dims(e_layer_dims, d_layer_dims):
    if e_layer_dims[-1] != d_layer_dims[0]:
        raise ValueError("ouput dimension of encoder and input dimension of "
                         "decoder do not match!")


class AutoEncoder(nn.Module):
    """An encoder and a decoder, ``decoder(encoder(x))``
    (``colvarsfinder_tpu/models/ae.py:58-121``).

    Args:
        e_layer_dims / d_layer_dims: layer dims of the encoder and the
            decoder; the encoder's last is the decoder's first.
        activation: nonlinearity name (or registry function).
        seed: the seed of the initial weights (the JAX ``key``).
        encoder / decoder: ready networks instead of the dims.
    """

    def __init__(self, e_layer_dims: Sequence[int] | None = None,
                 d_layer_dims: Sequence[int] | None = None,
                 activation="tanh", *, seed: int = 0,
                 encoder: Sequential | None = None,
                 decoder: Sequential | None = None):
        super().__init__()
        if encoder is None:
            _check_dims(e_layer_dims, d_layer_dims)
            generator = torch.Generator().manual_seed(seed)
            encoder = _sequential(e_layer_dims, activation, generator)
            decoder = _sequential(d_layer_dims, activation, generator)
        self.encoder = encoder
        self.decoder = decoder

    @classmethod
    def from_numpy(cls, encoder_params, decoder_params,
                   activation="tanh") -> "AutoEncoder":
        """The module computing the same function as a JAX ``AutoEncoder``
        whose ``encoder.params`` and ``decoder.params`` are given as numpy
        arrays."""
        return cls(encoder=_sequential_from_numpy(encoder_params, activation),
                   decoder=_sequential_from_numpy(decoder_params, activation))

    @property
    def encoded_dim(self) -> int:
        return self.encoder.layer_dims[-1]

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(inp))

    def get_params_of_cv(self, cv_idx: int):
        """The encoder's parameters of output ``cv_idx`` as one CV
        (``ae.py:34-55``)."""
        return self.encoder.get_params_of_cv(cv_idx)


class RegAutoEncoder(nn.Module):
    """An autoencoder with K scalar regularizer heads on its latent space
    (``colvarsfinder_tpu/models/ae.py:124-231``).

    Args:
        e_layer_dims / d_layer_dims: as :class:`AutoEncoder`.
        reg_layer_dims: layer dims of each head, from the encoder's output
            dim to 1.
        K: number of heads (0: none; ``forward_reg`` then raises).
        activation / seed: as :class:`AutoEncoder`; the heads use the
            encoder's activation.
        encoder / decoder / reg: ready networks instead of the dims.
    """

    def __init__(self, e_layer_dims: Sequence[int] | None = None,
                 d_layer_dims: Sequence[int] | None = None,
                 reg_layer_dims: Sequence[int] | None = None,
                 K: int | None = None, activation="tanh", *, seed: int = 0,
                 encoder: Sequential | None = None,
                 decoder: Sequential | None = None,
                 reg: EigenFunctions | None = None):
        if encoder is None:
            _check_dims(e_layer_dims, d_layer_dims)
            if K and e_layer_dims[-1] != reg_layer_dims[0]:
                raise ValueError("ouput dimension of encoder and input "
                                 "dimension of regulator part do not match!")
            generator = torch.Generator().manual_seed(seed)
            encoder = _sequential(e_layer_dims, activation, generator)
            decoder = _sequential(d_layer_dims, activation, generator)
            if K:
                reg = EigenFunctions(reg_layer_dims, K, activation,
                                     generator=generator)
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.reg = reg

    @classmethod
    def from_numpy(cls, encoder_params, decoder_params, reg_params=None,
                   activation="tanh") -> "RegAutoEncoder":
        """The module computing the same function as a JAX
        ``RegAutoEncoder`` whose ``encoder.params``, ``decoder.params`` and
        stacked ``reg`` (per layer ``{'weight': [K, o, i], 'bias': [K, o]}``)
        are given as numpy arrays."""
        reg = None
        if reg_params is not None:
            reg = EigenFunctions.from_numpy(reg_params, activation)
        return cls(encoder=_sequential_from_numpy(encoder_params, activation),
                   decoder=_sequential_from_numpy(decoder_params, activation),
                   reg=reg)

    @property
    def encoded_dim(self) -> int:
        return self.encoder.layer_dims[-1]

    @property
    def num_reg(self) -> int:
        return 0 if self.reg is None else self.reg.k

    @property
    def activation(self) -> str:
        return self.encoder.activation

    def forward_ae(self, inp: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(inp))

    def forward_reg(self, inp: torch.Tensor) -> torch.Tensor:
        """The K heads on the latent space: ``[B, d] -> [B, K]``."""
        if self.reg is None:
            raise ValueError("number of regularizers is not positive.")
        return self.reg(self.encoder(inp))

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """``[decoder(e), heads(e)]`` with ``e = encoder(inp)``."""
        if self.reg is None:
            raise ValueError("number of regularizers is not positive.")
        encoded = self.encoder(inp)
        return torch.cat((self.decoder(encoded), self.reg(encoded)), dim=1)

    def get_params_of_cv(self, cv_idx: int):
        """The encoder's parameters of output ``cv_idx`` as one CV."""
        return self.encoder.get_params_of_cv(cv_idx)


class RegModel(nn.Module):
    """The eigenfunctions of a trained :class:`RegAutoEncoder`: its encoder
    followed by its heads in the order ``cvec``
    (``colvarsfinder_tpu/models/ae.py:234-297``). The encoder is the
    autoencoder's own module; the heads are a reordered copy."""

    def __init__(self, reg_ae: RegAutoEncoder, cvec):
        super().__init__()
        if reg_ae.num_reg <= 0:
            raise ValueError("number of regularizers is not positive.")
        cvec = [int(c) for c in np.asarray(cvec).tolist()]
        if len(cvec) != reg_ae.num_reg:
            raise ValueError("length of cvec doesn't equal to number of "
                             "regularizers")
        self.encoder = reg_ae.encoder
        self.reg = reg_ae.reg.reordered(cvec)  # raises unless a permutation
        self.cvec = tuple(cvec)

    @property
    def encoded_dim(self) -> int:
        return self.encoder.layer_dims[-1]

    @property
    def num_reg(self) -> int:
        return self.reg.k

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.reg(self.encoder(inp))
