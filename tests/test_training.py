"""Learner + self-play engine tests, incl. a mini end-to-end slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.envs import TicTacToe
from nuzero.networks import MLPNetwork, NetworkManager, RecurrentNet
from nuzero.search import SearchParams
from nuzero.training import Learner, make_selfplay_step
from nuzero.training.learner import LearnerConfig
from nuzero.training.replay import add_games, create_buffer, sample
from nuzero.training.selfplay import init_selfplay

ENV = TicTacToe()


def _mlp_manager():
    return NetworkManager(MLPNetwork(out_features=9), ENV.observation_shape)


def _fixed_batch(batch=32, seed=0):
    rng = np.random.default_rng(seed)
    obs = jnp.asarray(
        rng.integers(0, 2, (batch,) + ENV.observation_shape), jnp.float32
    )
    pol = jax.nn.softmax(jnp.asarray(rng.standard_normal((batch, 9)), jnp.float32))
    val = jnp.asarray(rng.uniform(-1, 1, batch), jnp.float32)
    gt = jnp.zeros(batch, jnp.int32)
    return obs, pol, val, gt


def test_learner_reduces_loss():
    mgr = _mlp_manager()
    learner = Learner(mgr, LearnerConfig(learning_rate=3e-3))
    state = learner.init_state(jax.random.key(0))
    batch = _fixed_batch()
    step = jax.jit(learner.train_step)
    _, first = step(state, batch, jax.random.key(1))
    for i in range(60):
        state, metrics = step(state, batch, jax.random.key(i))
    assert float(metrics["loss/combined"]) < float(first["loss/combined"])
    assert np.isfinite(float(metrics["grad_norm"]))


def test_learner_sgd_nesterov():
    mgr = _mlp_manager()
    learner = Learner(
        mgr,
        LearnerConfig(
            optimizer="SGD",
            learning_rate=0.1,
            momentum=0.9,
            nesterov=True,
            scheduler_boundaries=(5, 10),
            scheduler_gamma=0.5,
        ),
    )
    state = learner.init_state(jax.random.key(0))
    batch = _fixed_batch()
    step = jax.jit(learner.train_step)
    for i in range(12):
        state, metrics = step(state, batch, jax.random.key(i))
    assert int(state.step) == 12
    assert np.isfinite(float(metrics["loss/combined"]))


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_recurrent_learner_prog_loss(alpha):
    net = RecurrentNet(policy_channels=1, num_filters=8, num_blocks=1)
    mgr = NetworkManager(net, ENV.observation_shape)
    learner = Learner(
        mgr,
        LearnerConfig(
            learning_rate=1e-3, train_iterations=3, prog_alpha=alpha
        ),
    )
    state = learner.init_state(jax.random.key(0))
    batch = _fixed_batch(batch=8)
    step = jax.jit(learner.train_step)
    for i in range(3):
        state, metrics = step(state, batch, jax.random.key(i))
    assert np.isfinite(float(metrics["loss/combined"]))
    assert float(metrics["grad_norm"]) > 0


def test_selfplay_emits_valid_games():
    mgr = _mlp_manager()
    variables = mgr.init(jax.random.key(0))

    def net(v, obs):
        p, val, _ = mgr.apply(v, obs)
        return p, val

    step = jax.jit(
        make_selfplay_step(ENV, net, SearchParams(num_simulations=16))
    )
    sp = init_selfplay(ENV, 16, jax.random.key(1))
    total_finished = 0
    for _ in range(12):  # enough lockstep moves to finish all first games
        sp, finished, stats = step(variables, sp)
        m = np.asarray(finished.mask)
        total_finished += int(m.sum())
        if m.any():
            lengths = np.asarray(finished.length)[m]
            assert ((lengths >= 5) & (lengths <= 9)).all()
            vals = np.asarray(finished.final_value)[m]
            assert np.isin(vals, [-1.0, 0.0, 1.0]).all()
            # recorded policies are distributions over the played prefix
            for bi in np.flatnonzero(m):
                ln = int(finished.length[bi])
                psum = np.asarray(finished.policy[bi, :ln].sum(axis=-1))
                np.testing.assert_allclose(psum, 1.0, atol=1e-4)
    assert total_finished >= 16  # every initial game finished within 12 moves
    assert int(sp.total_games) == total_finished


def test_selfplay_to_replay_to_learner_end_to_end():
    """The minimum end-to-end slice: play -> store -> sample -> update."""
    mgr = _mlp_manager()
    learner = Learner(mgr, LearnerConfig(learning_rate=1e-3))
    state = learner.init_state(jax.random.key(0))

    def net(v, obs):
        p, val, _ = mgr.apply(v, obs)
        return p, val

    sp_step = jax.jit(
        make_selfplay_step(ENV, net, SearchParams(num_simulations=16))
    )
    tr_step = jax.jit(learner.train_step)
    add = jax.jit(add_games)

    from nuzero.utils.packing import make_packer

    pack, unpack, D = make_packer(ENV.init(jax.random.key(0)))
    sp = init_selfplay(ENV, 8, jax.random.key(1))
    buf = create_buffer(64, ENV.max_game_length, D, 9)
    for _ in range(10):
        sp, finished, _ = sp_step(state.params, sp)
        buf = add(buf, finished)
    assert int(buf.num_games) >= 8

    losses = []
    for i in range(5):
        enc, pol, val, gt = sample(buf, jax.random.key(i), 32)
        obs = jax.vmap(lambda v: ENV.observe(unpack(v)))(enc)
        state, metrics = tr_step(state, (obs, pol, val, gt), jax.random.key(100 + i))
        losses.append(float(metrics["loss/combined"]))
    assert all(np.isfinite(losses))
    assert int(state.step) == 5
