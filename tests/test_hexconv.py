"""Hex convolution vs the NumPy neighbor-gather oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.ops.hexconv import (
    hex_conv,
    hex_conv_reference,
    hex_neighbor_offsets,
)


def test_neighbor_offsets_match_scs_rules():
    """Offsets must reproduce SCS_Game.py:1199-1243 geometry."""
    even = {d: tuple(o) for d, o in zip(
        ("c", "n", "ne", "se", "s", "sw", "nw"), hex_neighbor_offsets(0))}
    odd = {d: tuple(o) for d, o in zip(
        ("c", "n", "ne", "se", "s", "sw", "nw"), hex_neighbor_offsets(1))}
    assert even["n"] == (-1, 0) and odd["n"] == (-1, 0)
    assert even["s"] == (1, 0) and odd["s"] == (1, 0)
    assert even["ne"] == (-1, 1) and odd["ne"] == (0, 1)
    assert even["se"] == (0, 1) and odd["se"] == (1, 1)
    assert even["sw"] == (0, -1) and odd["sw"] == (1, -1)
    assert even["nw"] == (-1, -1) and odd["nw"] == (0, -1)


@pytest.mark.parametrize(
    "rows,cols", [(3, 3), (5, 5), (4, 7), (8, 6), (1, 1), (10, 10), (15, 15)]
)
def test_matches_oracle(rows, cols):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, 3, rows, cols)).astype(np.float32)
    w = rng.standard_normal((7, 3, 4)).astype(np.float32)
    got = np.asarray(hex_conv(jnp.asarray(x), jnp.asarray(w)))
    want = hex_conv_reference(x, w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_identity_kernel():
    """Center-only weights = per-pixel channel mix."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 2, 6, 5)).astype(np.float32)
    w = np.zeros((7, 2, 2), np.float32)
    w[0] = np.eye(2)
    got = np.asarray(hex_conv(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-5)


def test_single_neighbor_tap():
    """'n' tap alone shifts rows down by one (value at (r,c) <- (r-1,c))."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 0] = 1.0
    w = np.zeros((7, 1, 1), np.float32)
    w[1] = 1.0  # n tap: output at (r, c) reads input at (r-1, c)
    got = np.asarray(hex_conv(jnp.asarray(x), jnp.asarray(w)))
    want = np.zeros_like(x)
    want[0, 0, 1, 0] = 1.0
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_parity_dependence():
    """A 'ne' tap reads different rows for even vs odd columns."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 2, 1] = 1.0  # source at row 2, col 1 (odd col)
    w = np.zeros((7, 1, 1), np.float32)
    w[2] = 1.0  # ne
    got = np.asarray(hex_conv(jnp.asarray(x), jnp.asarray(w)))
    want = hex_conv_reference(x, w)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # even col 0 at row 3: ne=( -1,+1 ) -> reads (2,1): hit
    assert got[0, 0, 3, 0] == 1.0
    # odd col... cross-checked fully by the oracle above


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2)))


def test_bf16_wide_matches_f32_oracle():
    """bf16 operands at the flagship width (256 -> 256) pass through as
    bf16 and accumulate in f32: against the f32 oracle on the same
    bf16-rounded inputs only the final rounding to bf16 remains (about
    1e-3 rel-RMS; bf16 accumulation of 1792 products would be ~1e-2)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 5, 5, 256)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((7, 256, 256)) / np.sqrt(1792), jnp.bfloat16)
    got = hex_conv(x, w, data_format="NHWC", precision=None)
    assert got.dtype == jnp.bfloat16
    want = hex_conv_reference(
        np.asarray(x.astype(jnp.float32)).transpose(0, 3, 1, 2),
        np.asarray(w.astype(jnp.float32)),
    )
    got = np.asarray(got.astype(jnp.float32)).transpose(0, 3, 1, 2)
    assert _rel_rms(got, want) < 5e-3


def test_grad_through_bf16_hexconv_layer():
    """The dtype policy: a bf16 HexConv layer differentiates (no
    preferred_element_type=f32 on bf16 operands, which breaks the conv
    transpose rule), returns bf16, and keeps f32 master weights whose
    gradient matches the f32 layer's."""
    from nuzero.networks import HexConv

    x = jnp.asarray(np.random.default_rng(4).standard_normal((2, 5, 5, 8)), jnp.float32)
    layer16, layer32 = HexConv(16, dtype=jnp.bfloat16), HexConv(16)
    variables = layer16.init(jax.random.key(0), x)
    assert variables["params"]["kernel"].dtype == jnp.float32
    assert layer16.apply(variables, x).dtype == jnp.bfloat16

    def loss(layer):
        return lambda v: jnp.sum(layer.apply(v, x).astype(jnp.float32) ** 2)

    g16 = jax.grad(loss(layer16))(variables)["params"]["kernel"]
    g32 = jax.grad(loss(layer32))(variables)["params"]["kernel"]
    assert g16.dtype == jnp.float32
    assert _rel_rms(np.asarray(g16), np.asarray(g32)) < 3e-2


def test_gradients_flow():
    x = jnp.ones((1, 2, 5, 5))
    w = jnp.ones((7, 2, 3)) * 0.1

    def loss(w):
        return jnp.sum(hex_conv(x, w) ** 2)

    g = jax.grad(loss)(w)
    assert g.shape == w.shape
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).sum()) > 0


@pytest.mark.parametrize("rows,cols", [(5, 5), (4, 7)])
def test_depthwise_matches_oracle(rows, cols):
    from nuzero.ops.hexconv import (
        hex_conv_depthwise,
        hex_conv_depthwise_reference,
    )

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, rows, cols)).astype(np.float32)
    w = rng.standard_normal((7, 6)).astype(np.float32)
    got = np.asarray(
        hex_conv_depthwise(jnp.asarray(x), jnp.asarray(w), data_format="NCHW")
    )
    want = hex_conv_depthwise_reference(x, w)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # NHWC path agrees with NCHW.
    got_nhwc = np.asarray(
        hex_conv_depthwise(
            jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
            jnp.asarray(w),
            data_format="NHWC",
        )
    )
    np.testing.assert_allclose(
        np.transpose(got_nhwc, (0, 3, 1, 2)), want, atol=1e-4
    )


def test_depthwise_is_per_channel():
    """Depthwise semantics: output channel i depends only on input channel
    i (the reference's loop of per-channel Conv2d(1,1) layers)."""
    from nuzero.ops.hexconv import hex_conv_depthwise

    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 4, 5, 5)).astype(np.float32)
    w = rng.standard_normal((7, 4)).astype(np.float32)
    base = np.asarray(hex_conv_depthwise(jnp.asarray(x), jnp.asarray(w), data_format="NCHW"))
    x2 = x.copy()
    x2[:, 2] += 1.0  # perturb channel 2 only
    out2 = np.asarray(hex_conv_depthwise(jnp.asarray(x2), jnp.asarray(w), data_format="NCHW"))
    diff = np.abs(out2 - base).sum(axis=(0, 2, 3))
    assert diff[2] > 0
    assert diff[0] == diff[1] == diff[3] == 0
