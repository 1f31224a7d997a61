"""MLP policy/value network (ref ``Architectures/MLP_Network.py``).

Flatten -> Dense(64) -> SiLU, then ``hidden_layers`` x (Dense -> SiLU).
Policy head: 3 dense layers interpolating widths toward ``out_features``,
ReLU after *every* layer (the reference applies the activation after the
final policy layer too — ``MLP_Network.py:36-39`` — so "logits" are
non-negative; search softmaxes them regardless).
Value head: 3 dense layers interpolating toward 1, tanh after every layer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nuzero.networks import core as nn
from nuzero.networks.blocks import _ramp


class MLPNetwork(nn.Module):
    out_features: int
    hidden_layers: int = 4
    neurons_per_layer: int = 64
    dtype: jnp.dtype = jnp.float32

    recurrent: bool = False

    def __call__(self, x: jax.Array, train: bool = False):
        del train
        x = x.reshape(x.shape[0], -1).astype(self.dtype)
        x = nn.silu(nn.Dense(self.neurons_per_layer, dtype=self.dtype)(x))
        for _ in range(self.hidden_layers):
            x = nn.silu(nn.Dense(self.neurons_per_layer, dtype=self.dtype)(x))

        p = x
        for width in _ramp(self.neurons_per_layer, self.out_features, 3):
            p = nn.relu(nn.Dense(width, dtype=self.dtype)(p))

        v = x
        for width in _ramp(self.neurons_per_layer, 1, 3):
            v = nn.tanh(nn.Dense(width, dtype=self.dtype)(v))

        return p, v[:, 0]
