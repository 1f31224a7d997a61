"""Batched MCTS invariants + tactical correctness on Tic-Tac-Toe.

Uses a uniform-prior, zero-value "network" so the tests exercise pure
search behavior (PUCT + backprop + terminal handling) deterministically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.envs import TicTacToe
from nuzero.search import SearchParams, make_search_fn

ENV = TicTacToe()


def uniform_net(variables, obs):
    del variables
    batch = obs.shape[0]
    return jnp.zeros((batch, 9)), jnp.zeros((batch,))


def _search(states, *, sims=200, training=False, seed=0):
    params = SearchParams(num_simulations=sims)
    fn = jax.jit(make_search_fn(ENV, uniform_net, params, training))
    lengths = states.length
    return fn(None, states, lengths, jax.random.key(seed))


def _batchify(state_list):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *state_list)


def _play(moves):
    s = ENV.init(None)
    for a in moves:
        s = ENV.step(s, jnp.int32(a))
    return s


def test_finds_immediate_win():
    # p0 has 0,1 -> winning move is 2. (p1 played 3, 4)
    s = _play([0, 3, 1, 4])
    res = _search(_batchify([s]))
    assert int(res.action[0]) == 2


def test_blocks_immediate_loss():
    # p1 to move; p0 threatens 0,1,_ -> p1 must block at 2.
    s = _play([0, 8, 1])
    res = _search(_batchify([s]))
    assert int(res.action[0]) == 2


def test_root_value_sign():
    # Position winning for p0 (two ways to win, p0 to move).
    s_good = _play([4, 1, 0, 5])  # p0 has 4,0; threats 8 (diag) ...
    res = _search(_batchify([s_good]), sims=300)
    assert float(res.root_value[0]) > 0.3
    # Mirror: p1 holds 0,4,2 -> double threat (8 via 0-4-8, 6 via 2-4-6);
    # p0 (1,5,7) has no win and can only block one.
    s_bad = _play([1, 0, 5, 4, 7, 2])
    res2 = _search(_batchify([s_bad]), sims=300)
    assert float(res2.root_value[0]) < -0.3


def test_policy_target_valid_distribution():
    s = _play([4])
    res = _search(_batchify([s]), sims=100)
    pt = np.asarray(res.policy_target[0])
    assert pt.sum() == pytest.approx(1.0, abs=1e-5)
    legal = np.asarray(ENV.legal_mask(s))
    assert (pt[~legal] == 0).all()
    assert int(res.root_visits[0]) == 100
    assert int(res.tree_nodes[0]) <= 101


def test_batch_consistency():
    """Searching two positions in one batch == searching them separately."""
    s1 = _play([0, 3, 1, 4])
    s2 = _play([0, 8, 1])
    both = _search(_batchify([s1, s2]))
    alone1 = _search(_batchify([s1]))
    alone2 = _search(_batchify([s2]))
    assert int(both.action[0]) == int(alone1.action[0]) == 2
    assert int(both.action[1]) == int(alone2.action[1]) == 2
    np.testing.assert_allclose(
        np.asarray(both.root_value[0]), np.asarray(alone1.root_value[0]), atol=1e-5
    )


def test_training_mode_runs_and_legal():
    states = _batchify([_play([]), _play([4]), _play([0, 1])])
    res = _search(states, sims=50, training=True, seed=3)
    for i, moves in enumerate([[], [4], [0, 1]]):
        legal = np.asarray(ENV.legal_mask(_play(moves)))
        assert legal[int(res.action[i])]


def test_full_selfplay_game_terminates():
    """Drive a full game with eval-mode search each move."""
    s = ENV.init(None)
    guard = 0
    while not bool(ENV.terminal(s)) and guard < 12:
        res = _search(_batchify([s]), sims=64, seed=guard)
        a = int(res.action[0])
        assert bool(ENV.legal_mask(s)[a])
        s = ENV.step(s, jnp.int32(a))
        guard += 1
    assert bool(ENV.terminal(s))
    # The deeper-searching first player must never lose.  (A forced draw
    # needs >=1000 sims with uniform priors — verified separately; at 64
    # sims the second player may misdefend, so p0 winning is acceptable.)
    assert float(s.terminal_value) >= 0.0


def test_exploration_bias_matches_formula():
    s = _play([])
    res = _search(_batchify([s]), sims=100)
    n = float(res.root_visits[0])
    want = np.log((n + 10000 + 1) / 10000) + 1.15
    assert float(res.exploration_bias[0]) == pytest.approx(want, rel=1e-5)


def test_print_tree_dump():
    """Host-side tree dump (ref Explorer.print_tree, Explorer.py:216)."""
    import io

    from nuzero.networks import MLPNetwork, NetworkManager
    from nuzero.search.tree import print_tree

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    variables = mgr.init(jax.random.key(0))

    def net(v, obs):
        p, val, _ = mgr.apply(v, obs)
        return p, val

    params = SearchParams(num_simulations=16, keep_subtree=True)
    search = jax.jit(
        make_search_fn(env, net, params, training=False, with_tree=True)
    )
    states = jax.tree.map(lambda x: jnp.stack([x]), env.init(jax.random.key(1)))
    res, tree = search(
        variables, states, jnp.zeros(1, jnp.int32), jax.random.key(2),
        None, None,
    )
    buf = io.StringIO()
    out = print_tree(tree, game_idx=0, file=buf)
    assert "allocated nodes" in out
    assert "node 0:" in out
    # Root visit count appears (16 sims -> n=16 at the root).
    assert f"n={int(res.root_visits[0])}" in out
