"""Subtree reuse (keep_subtree): re-rooting invariants + selfplay carry.

Ref behavior: ``Training/Gamer.py:78-79`` root swap after each move,
search-config ``keep_subtree`` flag.  Here the reuse re-points the array
tree's root and frees the dead slots in place — node ids are stable
(``nuzero/search/tree.py::reroot``).
"""

import jax
import jax.numpy as jnp
import numpy as np

from nuzero.envs import TicTacToe
from nuzero.search import SearchParams, make_search_fn, reroot

ENV = TicTacToe()


def uniform_net(variables, obs):
    del variables
    batch = obs.shape[0]
    return jnp.zeros((batch, 9)), jnp.zeros((batch,))


def _initial_batch(n):
    return jax.vmap(ENV.init)(jax.random.split(jax.random.key(7), n))


def _carry_search(params, training=False):
    return jax.jit(
        make_search_fn(ENV, uniform_net, params, training, with_tree=True)
    )


def test_reroot_preserves_subtree_stats():
    params = SearchParams(num_simulations=64)
    fn = _carry_search(params)
    states = _initial_batch(4)
    res, tree = fn(
        None, states, jnp.zeros(4, jnp.int32), jax.random.key(0),
        None, None,
    )
    new_tree, ok = jax.vmap(reroot)(tree, res.action)
    assert bool(ok.all()), "argmax action of a 64-sim search must have a child"

    for b in range(4):
        t = jax.tree.map(lambda x: np.asarray(x[b]), tree)
        nt = jax.tree.map(lambda x: np.asarray(x[b]), new_tree)
        N = t.visit.shape[0]
        old_root = int(t.root)
        c = t.child[old_root, int(res.action[b])]
        # The root is re-POINTED (node ids are stable, no compaction).
        assert int(nt.root) == c
        assert nt.visit[c] == t.visit[c]
        assert np.isclose(nt.value_sum[c], t.value_sum[c])
        assert nt.parent[c] == -1  # severed from the freed old root
        assert np.array_equal(nt.legal[c], t.legal[c])
        # Grandchildren survive untouched at their old slots.
        for a in range(9):
            assert nt.child[c, a] == t.child[c, a]
            gc = t.child[c, a]
            if gc != -1:
                assert nt.visit[gc] == t.visit[gc]
                assert np.isclose(nt.value_sum[gc], t.value_sum[gc])
        # The free list is exactly the complement of c's subtree.
        live = ~nt.free
        expect_live = {c} | {
            i for i in range(N) if _has_ancestor(t.parent, i, c)
        }
        assert set(np.flatnonzero(live).tolist()) == expect_live
        assert 1 <= live.sum() <= int((~t.free).sum())
        # Pointer consistency over live slots.
        for i in np.flatnonzero(live):
            p = nt.parent[i]
            if i != c:
                assert live[p]
                assert (nt.child[p] == i).sum() == 1
            for a in range(9):
                ch = nt.child[i, a]
                if ch != -1:
                    assert live[ch]
                    assert nt.parent[ch] == i
        # Freed slots are cleanly reset for future allocation.
        dead = np.flatnonzero(nt.free)
        assert (nt.child[dead] == -1).all()
        assert (nt.visit[dead] == 0).all()
        assert not nt.expanded[dead].any()


def _has_ancestor(parent, i, c):
    """True if c is a strict ancestor of i (host-side oracle)."""
    seen = 0
    while parent[i] >= 0 and seen < parent.shape[0]:
        i = parent[i]
        seen += 1
        if i == c:
            return True
    return False


def test_reroot_missing_child_flags_invalid():
    params = SearchParams(num_simulations=4)
    fn = _carry_search(params)
    states = _initial_batch(2)
    res, tree = fn(
        None, states, jnp.zeros(2, jnp.int32), jax.random.key(0),
        None, None,
    )
    # Force an action that a 4-sim search did not materialize: the least
    # visited one.  With 4 sims over 9 legal root actions some child is -1.
    child = np.asarray(
        tree.child[jnp.arange(2), tree.root, :]
    )
    missing = jnp.int32([int(np.argmin(child[b] >= 0)) for b in range(2)])
    assert (
        np.asarray(tree.child[jnp.arange(2), tree.root, missing]) == -1
    ).any()
    _, ok = jax.vmap(reroot)(tree, missing)
    assert not bool(ok.all())


def test_carried_search_accumulates_visits():
    """A search seeded with a carried subtree starts from its visit counts."""
    params = SearchParams(num_simulations=32)
    fn = _carry_search(params)
    states = _initial_batch(3)
    zeros = jnp.zeros(3, jnp.int32)
    res1, tree1 = fn(None, states, zeros, jax.random.key(0), None, None)
    stepped = jax.vmap(ENV.step)(states, res1.action)
    tree2, ok = jax.vmap(reroot)(tree1, res1.action)
    assert bool(ok.all())
    res2, _ = fn(
        None, stepped, zeros + 1, jax.random.key(1), tree2, ok
    )
    carried_visits = tree2.visit[jnp.arange(3), tree2.root]
    # Carried roots run all num_simulations descents, like the reference's
    # run_mcts on an already-expanded root (Explorer.py:49-58) — fresh
    # roots spend their first simulation on the root evaluation instead.
    assert (np.asarray(res2.root_visits)
            == np.asarray(carried_visits) + params.num_simulations).all()


def test_selfplay_with_reuse_runs_and_stays_bounded():
    from nuzero.training.selfplay import init_selfplay, make_selfplay_step

    params = SearchParams(num_simulations=16)
    step = jax.jit(make_selfplay_step(ENV, uniform_net, params))
    sp = init_selfplay(ENV, 8, jax.random.key(3), search_params=params)
    assert sp.tree is not None
    cap = 2 * params.num_simulations + 4
    finished_total = 0
    for _ in range(25):
        sp, finished, stats = step(None, sp)
        finished_total += int(stats["finished"])
        assert int((~sp.tree.free).sum(-1).max()) <= cap
        # Valid carried roots must match the game's current position count.
        pt = np.asarray(finished.policy)
        assert np.isfinite(pt).all()
    assert finished_total > 0
    assert int(sp.total_games) == finished_total


def test_selfplay_reuse_matches_fresh_quality():
    """Reuse must not break learning signal plumbing: policy targets stay
    distributions over legal moves."""
    from nuzero.training.selfplay import init_selfplay, make_selfplay_step

    params = SearchParams(num_simulations=24)
    step = jax.jit(make_selfplay_step(ENV, uniform_net, params))
    sp = init_selfplay(ENV, 4, jax.random.key(5), search_params=params)
    for _ in range(6):
        legal = np.asarray(jax.vmap(ENV.legal_mask)(sp.games))
        counts = np.asarray(sp.move_count)
        sp, _, _ = step(None, sp)
        row = np.asarray(sp.policy_buf)[np.arange(4), counts]
        for b in range(4):
            np.testing.assert_allclose(row[b].sum(), 1.0, rtol=1e-5)
            assert (row[b][~legal[b]] == 0).all()
