"""Hexagonal convolution on offset-coordinate hex grids (HexagDLy semantics).

The reference stores hex boards as rectangular tensors in *offset
coordinates*: columns are vertical, and the vertical placement of a column's
neighbors depends on the column's parity (ref ``Games/SCS/SCS_Game.py:26-65``,
neighbor rules at ``SCS_Game.py:1199-1243``):

    n  = (r-1, c)            s  = (r+1, c)
    even column c:  ne=(r-1,c+1)  se=(r,c+1)   sw=(r,c-1)   nw=(r-1,c-1)
    odd  column c:  ne=(r,c+1)    se=(r+1,c+1) sw=(r+1,c-1) nw=(r,c-1)

A size-1 hexagonal kernel covers the center + its 6 hex neighbors, with one
independent weight per hex direction (shared across column parities), zero
padding at the board edge — the behavior of ``hexagdly.Conv2d(kernel_size=1)``
used throughout the reference's model zoo (ref
``Neural_Networks/Architectures/blocks.py:20``).

Design: instead of gather-based neighbor indexing, the 7 direction weights
are embedded into two dense 3x3 kernels — one laid out for even output
columns, one for odd — both run as ordinary XLA convolutions (cuDNN on the
GPU), and the output is selected per column parity.  The two convolutions
share 3 of 7 taps (n, s, center); XLA fuses the select into the conv
epilogue.  The dual conv does 18/7 = 2.6x the FLOPs of the 7 taps, in
exchange for needing no custom kernel and no gathers.

Direction order everywhere: [center, n, ne, se, s, sw, nw] (the reference's
clockwise order ``SCS_Game.py:1245-1247`` with center prepended).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: tap -> (row_offset, col_offset) per column parity
HEX_DIRECTIONS = ("c", "n", "ne", "se", "s", "sw", "nw")

_OFFSETS_EVEN = {
    "c": (0, 0),
    "n": (-1, 0),
    "ne": (-1, 1),
    "se": (0, 1),
    "s": (1, 0),
    "sw": (0, -1),
    "nw": (-1, -1),
}
_OFFSETS_ODD = {
    "c": (0, 0),
    "n": (-1, 0),
    "ne": (0, 1),
    "se": (1, 1),
    "s": (1, 0),
    "sw": (1, -1),
    "nw": (0, -1),
}


def hex_neighbor_offsets(parity: int):
    """(7, 2) int array of (dr, dc) offsets for a column of given parity."""
    table = _OFFSETS_ODD if parity % 2 else _OFFSETS_EVEN
    return np.array([table[d] for d in HEX_DIRECTIONS], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _placement(parity: int):
    """Indices placing the 7 taps into a 3x3 window for this parity."""
    offs = hex_neighbor_offsets(parity)
    rows = offs[:, 0] + 1
    cols = offs[:, 1] + 1
    return rows, cols


def hex_conv(
    x: jax.Array,
    weights: jax.Array,
    *,
    data_format: str = "NCHW",
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Hexagonal convolution.

    Args:
      x: f32[batch, in_channels, rows, cols] when ``data_format == "NCHW"``
        (the framework's (C, H, W) observation convention) or
        f32[batch, rows, cols, in_channels] when ``"NHWC"`` (the layout the
        network stacks use internally).
      weights: f32[7, in_channels, out_channels], tap order
        [c, n, ne, se, s, sw, nw].

    Returns:
      Output with the same layout as ``x``; zero padding at the edges.
    """
    if data_format == "NCHW":
        dense_layout = "OIHW"
        col_axis = 3
    elif data_format == "NHWC":
        dense_layout = "HWIO"
        col_axis = 2
    else:
        raise ValueError(f"bad data_format {data_format!r}")

    kernels = []
    for parity in (0, 1):
        rows, cols = _placement(parity)
        k = jnp.zeros((3, 3) + weights.shape[1:], weights.dtype)
        k = k.at[rows, cols].set(weights)  # [3, 3, in, out] == HWIO
        if dense_layout == "OIHW":
            k = jnp.transpose(k, (3, 2, 0, 1))
        kernels.append(k)
    k_even, k_odd = kernels

    dn = jax.lax.conv_dimension_numbers(
        x.shape, k_even.shape, (data_format, dense_layout, data_format)
    )
    # Dtype policy: operands keep their dtype.  f32 asks for an f32
    # result explicitly; bf16 operands go through as bf16, since
    # ``preferred_element_type=f32`` with bf16 operands breaks the conv
    # transpose rule (the f32 cotangent meets the bf16 kernel in the
    # gradient conv).  XLA accumulates bf16 convs in f32 on CPU and GPU
    # (checked against the f32 oracle in tests/test_hexconv.py and on the
    # card by chip_smoke.py).
    conv = functools.partial(
        jax.lax.conv_general_dilated,
        window_strides=(1, 1),
        padding=((1, 1), (1, 1)),
        dimension_numbers=dn,
        precision=precision,
        preferred_element_type=(
            jnp.float32 if x.dtype == jnp.float32 else None
        ),
    )
    y_even = conv(x, k_even)
    y_odd = conv(x, k_odd)
    col_is_odd = (jnp.arange(x.shape[col_axis]) % 2).astype(bool)
    shape = [1, 1, 1, 1]
    shape[col_axis] = -1
    return jnp.where(col_is_odd.reshape(shape), y_odd, y_even)


def hex_conv_depthwise(
    x: jax.Array,
    weights: jax.Array,
    *,
    data_format: str = "NHWC",
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Per-channel (depthwise) hexagonal convolution.

    The reference hand-rolls this as a Python loop of C independent
    ``hexagdly.Conv2d(1, 1)`` layers concatenated back together
    (ref ``Neural_Networks/Architectures/depthwise_conv.py:10-38``).  Here
    it is one grouped XLA convolution per column parity
    (``feature_group_count = C``), same dual-kernel parity trick as
    :func:`hex_conv`.

    Args:
      x: activations, NHWC or NCHW.
      weights: f32[7, channels] — one weight per (tap, channel).

    Returns:
      Same shape/layout as ``x``.
    """
    if data_format == "NCHW":
        col_axis = 3
        channels = x.shape[1]
    elif data_format == "NHWC":
        col_axis = 2
        channels = x.shape[-1]
    else:
        raise ValueError(f"bad data_format {data_format!r}")
    if weights.shape != (7, channels):
        raise ValueError(f"weights {weights.shape} != (7, {channels})")

    kernels = []
    for parity in (0, 1):
        rows, cols = _placement(parity)
        # HWIO with I = in/groups = 1, O = channels.
        k = jnp.zeros((3, 3, 1, channels), weights.dtype)
        k = k.at[rows, cols, 0].set(weights)
        if data_format == "NCHW":
            k = jnp.transpose(k, (3, 2, 0, 1))
        kernels.append(k)
    k_even, k_odd = kernels

    dense_layout = "OIHW" if data_format == "NCHW" else "HWIO"
    dn = jax.lax.conv_dimension_numbers(
        x.shape, k_even.shape, (data_format, dense_layout, data_format)
    )
    # Same dtype policy as hex_conv.
    conv = functools.partial(
        jax.lax.conv_general_dilated,
        window_strides=(1, 1),
        padding=((1, 1), (1, 1)),
        dimension_numbers=dn,
        feature_group_count=channels,
        precision=precision,
        preferred_element_type=(
            jnp.float32 if x.dtype == jnp.float32 else None
        ),
    )
    y_even = conv(x, k_even)
    y_odd = conv(x, k_odd)
    col_is_odd = (jnp.arange(x.shape[col_axis]) % 2).astype(bool)
    shape = [1, 1, 1, 1]
    shape[col_axis] = -1
    return jnp.where(col_is_odd.reshape(shape), y_odd, y_even)


def hex_conv_depthwise_reference(
    x: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """NumPy oracle for the depthwise hex conv (NCHW).  Test-only."""
    batch, cin, rows, cols = x.shape
    out = np.zeros_like(x, dtype=np.float32)
    for c in range(cols):
        offs = hex_neighbor_offsets(c % 2)
        for r in range(rows):
            acc = np.zeros((batch, cin), dtype=np.float32)
            for t, (dr, dc) in enumerate(offs):
                rr, cc = r + dr, c + dc
                if 0 <= rr < rows and 0 <= cc < cols:
                    acc += x[:, :, rr, cc] * weights[t][None, :]
            out[:, :, r, c] = acc
    return out


def hex_conv_reference(x: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Pure-NumPy oracle: explicit neighbor gathering.  Test-only."""
    batch, cin, rows, cols = x.shape
    _, _, cout = weights.shape
    out = np.zeros((batch, cout, rows, cols), dtype=np.float32)
    for c in range(cols):
        offs = hex_neighbor_offsets(c % 2)
        for r in range(rows):
            acc = np.zeros((batch, cout), dtype=np.float32)
            for t, (dr, dc) in enumerate(offs):
                rr, cc = r + dr, c + dc
                if 0 <= rr < rows and 0 <= cc < cols:
                    acc += x[:, :, rr, cc] @ weights[t]
            out[:, :, r, c] = acc
    return out
