"""Plain conv stack with ELU (ref ``Architectures/ConvNet.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from nuzero.networks import core as nn

from nuzero.networks.blocks import Conv, ReducePolicyHead, ReduceValueHead


class ConvNet(nn.Module):
    policy_channels: int
    num_filters: int = 256
    num_layers: int = 6
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    recurrent: bool = False

    def __call__(self, x: jax.Array, train: bool = False):
        del train  # no layer differs in training
        # (B, C, H, W) observation convention -> NHWC internal layout.
        x = jnp.transpose(x, (0, 2, 3, 1)).astype(self.dtype)
        x = nn.elu(Conv(self.num_filters, hex=self.hex, dtype=self.dtype)(x))
        for _ in range(self.num_layers):
            x = nn.elu(Conv(self.num_filters, hex=self.hex, dtype=self.dtype)(x))
        p = ReducePolicyHead(
            self.num_filters, self.policy_channels, hex=self.hex, dtype=self.dtype
        )(x)
        v = ReduceValueHead(self.num_filters, hex=self.hex, dtype=self.dtype)(x)
        return p.astype(jnp.float32), v.astype(jnp.float32)
