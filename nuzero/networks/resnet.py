"""Residual tower (ref ``Architectures/ResNet.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nuzero.networks import core as nn
from nuzero.networks.blocks import (
    BasicBlock,
    Conv,
    ReducePolicyHead,
    make_value_head,
)


class ResNet(nn.Module):
    policy_channels: int
    num_filters: int = 256
    num_blocks: int = 4
    policy_head: str = "conv"
    value_head: str = "reduce"  # "reduce" | "dense"
    value_activation: str = "tanh"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    recurrent: bool = False

    def __call__(self, x: jax.Array, train: bool = False):
        del train  # no layer differs in training
        x = jnp.transpose(x, (0, 2, 3, 1)).astype(self.dtype)
        x = nn.relu(Conv(self.num_filters, hex=self.hex, dtype=self.dtype)(x))
        for _ in range(self.num_blocks):
            x = BasicBlock(self.num_filters, hex=self.hex, dtype=self.dtype)(x)

        if self.policy_head != "conv":
            raise ValueError(f"ResNet policy head {self.policy_head!r} unavailable")
        p = ReducePolicyHead(
            self.num_filters, self.policy_channels, hex=self.hex, dtype=self.dtype
        )(x)

        # The reference's ResNet only matches reduce/dense
        # (ref ResNet.py:51-58) but the full registry is harmless here.
        v = make_value_head(
            self.value_head,
            self.num_filters,
            activation=self.value_activation,
            hex=self.hex,
            dtype=self.dtype,
        )(x)
        return p.astype(jnp.float32), v.astype(jnp.float32)
