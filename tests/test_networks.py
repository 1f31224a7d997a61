"""Network zoo smoke + semantics tests.

Mirrors the reference's System_Tests/Neural_Networks smoke tests (construct
each architecture against real game shapes and run one inference — SURVEY
§4), plus real assertions the reference lacks: shapes, finiteness, recurrent
weight sharing, interim-thought resumption, and iteration extrapolation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.networks import (
    ConvNet,
    MLPNetwork,
    NetworkManager,
    RecurrentNet,
    ResNet,
)

OBS = (5, 7, 7)  # (C, H, W) ~ a small SCS-like map
POLICY_CHANNELS = 12
NUM_ACTIONS = POLICY_CHANNELS * 7 * 7


def _obs(batch=2, shape=OBS, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((batch,) + shape), jnp.float32)


@pytest.mark.parametrize("hex", [True, False])
def test_convnet(hex):
    net = ConvNet(policy_channels=POLICY_CHANNELS, num_filters=32, num_layers=2, hex=hex)
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(0))
    p, v, interim = mgr.apply(variables, _obs())
    assert p.shape == (2, NUM_ACTIONS)
    assert v.shape == (2,)
    assert interim is None
    assert np.isfinite(np.asarray(p)).all() and np.isfinite(np.asarray(v)).all()
    assert (np.abs(np.asarray(v)) <= 1.0).all()


@pytest.mark.parametrize("hex", [True, False])
@pytest.mark.parametrize("value_head", ["reduce", "dense"])
def test_resnet(hex, value_head):
    net = ResNet(
        policy_channels=POLICY_CHANNELS,
        num_filters=32,
        num_blocks=2,
        value_head=value_head,
        hex=hex,
    )
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(1))
    p, v, _ = mgr.apply(variables, _obs())
    assert p.shape == (2, NUM_ACTIONS) and v.shape == (2,)


def test_mlp():
    net = MLPNetwork(out_features=9)
    mgr = NetworkManager(net, (2, 3, 3))
    variables = mgr.init(jax.random.key(2))
    p, v, _ = mgr.apply(variables, _obs(shape=(2, 3, 3)))
    assert p.shape == (2, 9) and v.shape == (2,)
    assert (np.asarray(p) >= 0).all()  # reference MLP relu-activates logits


@pytest.mark.parametrize("hex", [True, False])
def test_recurrent_smoke(hex):
    net = RecurrentNet(policy_channels=POLICY_CHANNELS, num_filters=32, num_blocks=1, hex=hex)
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(3))
    p, v, interim = mgr.apply(variables, _obs(), iters_to_do=40)
    assert p.shape == (2, NUM_ACTIONS) and v.shape == (2,)
    assert interim is not None and interim.shape == (2, 7, 7, 32)


def test_recurrent_weight_count_independent_of_iters():
    """Scanned recurrence must share weights across iterations."""
    net = RecurrentNet(policy_channels=2, num_filters=8, num_blocks=1)
    mgr = NetworkManager(net, OBS)
    v1 = net.init(jax.random.key(0), _obs(1), 1)
    v8 = net.init(jax.random.key(0), _obs(1), 8)
    n1 = sum(x.size for x in jax.tree.leaves(v1))
    n8 = sum(x.size for x in jax.tree.leaves(v8))
    assert n1 == n8


def test_recurrent_interim_resumption():
    """k iters then m iters from the interim == k+m iters in one call
    (the contract the progressive loss relies on)."""
    net = RecurrentNet(policy_channels=2, num_filters=8, num_blocks=1)
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(4))
    obs = _obs(1)
    _, _, interim_k = mgr.apply(variables, obs, iters_to_do=3)
    p_resumed, v_resumed, _ = mgr.apply(
        variables, obs, iters_to_do=2, interim_thought=interim_k
    )
    p_full, v_full, _ = mgr.apply(variables, obs, iters_to_do=5)
    np.testing.assert_allclose(
        np.asarray(p_resumed), np.asarray(p_full), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(v_resumed), np.asarray(v_full), rtol=1e-5, atol=1e-5
    )


def test_recurrent_extrapolation_changes_output():
    net = RecurrentNet(policy_channels=2, num_filters=8, num_blocks=1)
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(5))
    obs = _obs(1)
    p2, _, _ = mgr.apply(variables, obs, iters_to_do=2)
    p20, _, _ = mgr.apply(variables, obs, iters_to_do=20)
    assert not np.allclose(np.asarray(p2), np.asarray(p20))


def test_manager_inference_parity_shapes():
    net = RecurrentNet(policy_channels=2, num_filters=8, num_blocks=1)
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(6))
    out = mgr.inference(variables, _obs(1), training=True, iters_to_do=2)
    (p, v), interim = out
    assert interim is not None
    p2, v2 = mgr.inference(variables, _obs(1), training=False, iters_to_do=2)
    assert p2.shape == p.shape


def test_manager_rejects_module_without_recurrent_attr():
    from nuzero.networks import core as nn

    class Bad(nn.Module):
        def __call__(self, x):
            return x, x

    with pytest.raises(TypeError):
        NetworkManager(Bad(), OBS)


@pytest.mark.parametrize(
    "value_head",
    ["depth", "combined", "separable", "reverse", "rawsep", "strange"],
)
def test_discontinued_value_heads(value_head):
    """Every selector from the reference's zoo builds and runs
    (ref RecurrentNet.py:58-76, blocks.py:180-448)."""
    net = RecurrentNet(
        policy_channels=POLICY_CHANNELS,
        num_filters=16,
        num_blocks=1,
        value_head=value_head,
    )
    mgr = NetworkManager(net, OBS)
    variables = mgr.init(jax.random.key(0))
    p, v, interim = mgr.apply(variables, _obs(), iters_to_do=2)
    assert p.shape == (2, NUM_ACTIONS) and v.shape == (2,)
    assert np.isfinite(np.asarray(p)).all() and np.isfinite(np.asarray(v)).all()
    assert (np.abs(np.asarray(v)) <= 1.0).all()


def test_unknown_value_head_raises():
    from nuzero.networks import make_value_head

    with pytest.raises(ValueError, match="unknown value head"):
        make_value_head("bogus", 16)


def test_bf16_compute_trains():
    """Mixed precision: bf16 COMPUTE with f32 master params must be
    differentiable end-to-end (regression: preferred_element_type=f32
    with bf16 conv operands broke the conv transpose rule)."""
    import jax
    import jax.numpy as jnp

    net = RecurrentNet(
        policy_channels=2, num_filters=8, num_blocks=1, hex=True,
        dtype=jnp.bfloat16,
    )
    obs = jnp.ones((2, 3, 5, 5), jnp.float32)
    variables = net.init(jax.random.key(0), obs, 2)
    # Master params stay f32.
    assert all(
        x.dtype == jnp.float32 for x in jax.tree.leaves(variables)
    )

    def loss(v):
        (p, val), _ = net.apply(v, obs, 3)
        assert p.dtype == jnp.float32 and val.dtype == jnp.float32
        return (p ** 2).mean() + (val ** 2).mean()

    g = jax.grad(loss)(variables)
    flat = jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(g)])
    assert bool(jnp.isfinite(flat).all())
    assert float(jnp.abs(flat).max()) > 0
