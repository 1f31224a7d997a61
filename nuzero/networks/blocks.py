"""Shared network building blocks.

Behavioral targets: ``Neural_Networks/Architectures/blocks.py`` in the
reference, re-expressed as modules (``networks/core.py``) over NHWC
activations (the reference's torch code is NCHW).

All convolutions are bias-free, matching the reference
(``blocks.py:20,28,63,151``).  ``hex=True`` selects the HexagDLy-semantics
hexagonal convolution (one hex ring); ``hex=False`` a 3x3 'same' ortho conv.
Filter-count ramps reproduce the reference's ``int(width + k*step)``
arithmetic exactly so checkpoint shapes line up.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from nuzero.networks import core as nn
from nuzero.ops.hexconv import hex_conv, hex_conv_depthwise


def _ramp(start: int, end: int, num_layers: int) -> Sequence[int]:
    """Reference filter-ramp arithmetic (ref ``blocks.py:56-61``)."""
    step = (end - start) / num_layers
    sizes = []
    prev = float(start)
    for _ in range(num_layers):
        prev = prev + step
        sizes.append(int(prev))
    return sizes


class HexConv(nn.Module):
    """Hexagonal convolution layer (ref ``hexagdly.Conv2d(kernel_size=1)``).

    Input/output NHWC.  7 taps: [c, n, ne, se, s, sw, nw], independent
    weights per direction, zero edge padding, no bias.
    """

    features: int
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        in_features = x.shape[-1]
        # Same fan-in/out variance scaling torch uses for convs (kaiming
        # uniform over 7-tap receptive field).  Params stay f32 (master
        # weights); ``dtype`` is the COMPUTE dtype — bf16 runs the conv on
        # bf16 operands with f32 accumulation (mixed precision).
        w = self.param(
            "kernel",
            nn.initializers.variance_scaling(1 / 3, "fan_in", "uniform"),
            (7, in_features, self.features),
        )
        return hex_conv(
            x.astype(self.dtype),
            w.astype(self.dtype),
            data_format="NHWC",
            precision=None,
        )


class Conv(nn.Module):
    """Hex-or-ortho conv selector used by every stack in the zoo."""

    features: int
    hex: bool = True
    kernel_size: int = 3  # ortho only; hex is always one ring
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        if self.hex:
            return HexConv(self.features, dtype=self.dtype)(x)
        return nn.Conv(
            self.features, (self.kernel_size, self.kernel_size), dtype=self.dtype
        )(x)


class BasicBlock(nn.Module):
    """Residual block: conv -> relu -> conv, + identity, relu
    (ref ``blocks.py:12-41``)."""

    channels: int
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        out = Conv(self.channels, hex=self.hex, dtype=self.dtype)(x)
        out = nn.relu(out)
        out = Conv(self.channels, hex=self.hex, dtype=self.dtype)(out)
        return nn.relu(out + x)


class ReduceValueHead(nn.Module):
    """Conv filter-ramp down to 1 channel, then a global mean over channels
    *and* space, then tanh (ref ``blocks.py:46-92``; the reference's
    ``AdaptiveAvgPool3d(1)`` pools over (C, H, W) — with the final conv at 1
    channel this is a spatial global mean, reproduced as such)."""

    width: int
    num_reduce_layers: int = 4
    activation: str = "tanh"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        act = _act(self.activation)
        sizes = _ramp(self.width, 1, self.num_reduce_layers)
        for i, features in enumerate(sizes):
            x = Conv(features, hex=self.hex, dtype=self.dtype)(x)
            if i != len(sizes) - 1:
                x = act(x)
        # Global mean over (H, W, C); final channel count is 1.
        return _global_tanh(x)  # [batch]


class DenseValueHead(nn.Module):
    """conv -> flatten -> relu -> dense -> relu -> dense(1) -> tanh
    (ref ``blocks.py:97-125``; all layers bias-free)."""

    width: int
    dense_layer_neurons: int = 256
    conv_layer_channels: int = 32
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        x = Conv(self.conv_layer_channels, hex=self.hex, dtype=self.dtype)(x)
        x = x.reshape(x.shape[0], -1)
        x = nn.relu(x)
        x = nn.Dense(self.dense_layer_neurons, use_bias=False, dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Dense(1, use_bias=False, dtype=self.dtype)(x)
        return nn.tanh(x)[:, 0]  # [batch]


class HexDepthwiseConv(nn.Module):
    """Per-channel hexagonal conv (ref ``depthwise_conv.py:10-38``: a loop
    of C ``hexagdly.Conv2d(1,1)`` layers; here one grouped XLA conv)."""

    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        channels = x.shape[-1]
        w = self.param(
            "kernel",
            nn.initializers.variance_scaling(1 / 3, "fan_in", "uniform"),
            (7, channels),
        )
        return hex_conv_depthwise(
            x.astype(self.dtype), w.astype(self.dtype), data_format="NHWC"
        )


class DepthwiseConv(nn.Module):
    """Hex-or-ortho depthwise conv selector.

    Ortho mode is a grouped 3x3 conv.  Deviation from the reference: its
    ortho depthwise layers use VALID padding (torch's default), which
    shrinks the board 2 px per layer and crashes on the 5x5 scenarios; we
    use SAME padding uniformly, matching the hex path's zero-padding.
    """

    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        if self.hex:
            return HexDepthwiseConv(dtype=self.dtype)(x)
        channels = x.shape[-1]
        return nn.Conv(
            channels, (3, 3), feature_group_count=channels, dtype=self.dtype
        )(x)


def _act(name: str):
    return {"tanh": nn.tanh, "relu": nn.relu}[name]


def _global_tanh(x: jax.Array) -> jax.Array:
    """``AdaptiveAvgPool3d(1) -> Flatten -> Tanh`` tail shared by every
    reduce head (ref ``blocks.py:213-216`` et al.): global mean over
    channels *and* space, then tanh.  All heads reach this point at 1
    channel, so it is a spatial mean."""
    return nn.tanh(jnp.mean(x, axis=(1, 2, 3)))


class DepthValueHead(nn.Module):
    """4x [depthwise -> act], full conv to 1 channel, global tanh
    (ref ``Depth_ValueHead``, blocks.py:180-221).  Discontinued in the
    reference but kept selectable; same here."""

    width: int
    activation: str = "relu"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        for _ in range(4):
            x = DepthwiseConv(hex=self.hex, dtype=self.dtype)(x)
            x = _act(self.activation)(x)
        x = Conv(1, hex=self.hex, dtype=self.dtype)(x)
        return _global_tanh(x)


#: filter ramp shared by the remaining discontinued heads
#: (ref blocks.py:231,288,332,373,419)
_DISCONTINUED_RAMP = (256, 64, 8, 1)


class CombinedValueHead(nn.Module):
    """Per ramp step: depthwise -> act -> full conv down;
    (ref ``Combined_ValueHead``, blocks.py:226-280)."""

    width: int
    activation: str = "relu"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        for features in _DISCONTINUED_RAMP:
            x = DepthwiseConv(hex=self.hex, dtype=self.dtype)(x)
            x = _act(self.activation)(x)
            x = Conv(features, hex=self.hex, dtype=self.dtype)(x)
            if features != 1:
                x = _act(self.activation)(x)
        return _global_tanh(x)


class SeparableValueHead(nn.Module):
    """Depthwise-separable ramp: depthwise -> 1x1 pointwise per step
    (ref ``Separable_ValueHead``, blocks.py:284-324)."""

    width: int
    activation: str = "relu"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        for features in _DISCONTINUED_RAMP:
            x = DepthwiseConv(hex=self.hex, dtype=self.dtype)(x)
            x = nn.Conv(features, (1, 1), dtype=self.dtype)(x)
            if features != 1:
                x = _act(self.activation)(x)
        return _global_tanh(x)


class ReverseValueHead(nn.Module):
    """Reversed separable: 1x1 pointwise down, then depthwise
    (ref ``Reverse_ValueHead``, blocks.py:328-367)."""

    width: int
    activation: str = "relu"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        for features in _DISCONTINUED_RAMP:
            x = nn.Conv(features, (1, 1), dtype=self.dtype)(x)
            x = DepthwiseConv(hex=self.hex, dtype=self.dtype)(x)
            if features != 1:
                x = _act(self.activation)(x)
        return _global_tanh(x)


class RawSeparableValueHead(nn.Module):
    """Separable ramp with an ORTHO 3x3 depthwise regardless of hex mode —
    the reference ignores its hex flag here (ref ``RawSeparable_ValueHead``,
    blocks.py:371-407)."""

    width: int
    activation: str = "relu"
    hex: bool = True  # accepted for signature parity; unused by design
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        for features in _DISCONTINUED_RAMP:
            x = DepthwiseConv(hex=False, dtype=self.dtype)(x)
            x = nn.Conv(features, (1, 1), dtype=self.dtype)(x)
            if features != 1:
                x = _act(self.activation)(x)
        return _global_tanh(x)


class StrangeValueHead(nn.Module):
    """Per-channel 1x1 scaling then a full conv down per ramp step
    (ref ``Strange_ValueHead``, blocks.py:411-448: a groups=C kernel-1
    conv — one scalar per channel — followed by a normal conv)."""

    width: int
    activation: str = "relu"
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        for features in _DISCONTINUED_RAMP:
            channels = x.shape[-1]
            x = nn.Conv(
                channels, (1, 1), feature_group_count=channels, dtype=self.dtype
            )(x)
            x = Conv(features, hex=self.hex, dtype=self.dtype)(x)
            if features != 1:
                x = _act(self.activation)(x)
        return _global_tanh(x)


#: value-head registry; keys are the reference's selector strings
#: (ref RecurrentNet.py:58-76)
VALUE_HEADS = {
    "reduce": ReduceValueHead,
    "dense": DenseValueHead,
    "depth": DepthValueHead,
    "combined": CombinedValueHead,
    "separable": SeparableValueHead,
    "reverse": ReverseValueHead,
    "rawsep": RawSeparableValueHead,
    "strange": StrangeValueHead,
}


def make_value_head(
    name: str,
    width: int,
    *,
    activation: str = "tanh",
    hex: bool = True,
    dtype: jnp.dtype = jnp.float32,
) -> nn.Module:
    """Instantiate a value head by selector string
    (ref RecurrentNet.py:58-76, ResNet.py:51-58)."""
    try:
        cls = VALUE_HEADS[name]
    except KeyError:
        raise ValueError(
            f"unknown value head {name!r}; options: {sorted(VALUE_HEADS)}"
        ) from None
    if cls is DenseValueHead:
        return cls(width, hex=hex, dtype=dtype)
    # The nets pass value_activation straight through to every head
    # (ref RecurrentNet.py:60-72), so the discontinued heads see "tanh"
    # by default despite their own relu signature default.
    return cls(width, activation=activation, hex=hex, dtype=dtype)


class ReducePolicyHead(nn.Module):
    """Conv filter-ramp from trunk width down to the action-plane count
    (ref ``blocks.py:130-170``).  Returns flat logits [batch, num_actions]
    in (plane, row, col) C-order, matching the flat action index
    convention (ref ``Games/Game.py:96-102``)."""

    width: int
    policy_channels: int
    num_reduce_layers: int = 2
    hex: bool = True
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x: jax.Array) -> jax.Array:
        sizes = _ramp(self.width, self.policy_channels, self.num_reduce_layers)
        for i, features in enumerate(sizes):
            x = Conv(features, hex=self.hex, dtype=self.dtype)(x)
            if i != len(sizes) - 1:
                x = nn.relu(x)
        # NHWC -> NCHW -> flat, so logits ravel as (plane, row, col).
        x = jnp.transpose(x, (0, 3, 1, 2))
        return x.reshape(x.shape[0], -1)
