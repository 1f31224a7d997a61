"""Replay buffer: ring/window semantics, targets, sampling distributions."""

import jax
import jax.numpy as jnp
import numpy as np

from nuzero.training.replay import (
    FinishedGames,
    add_games,
    create_buffer,
    position_weights,
    sample,
    truncate_to_seq,
)

D = 18  # packed-state row width (opaque to the buffer)
A = 9
L = 9


def _finished(n, start_val=0.0, length=5, mask=None, batch=None):
    """Build a FinishedGames batch of `n` real games (batch rows >= n)."""
    b = batch or n
    enc = np.zeros((b, L, D), np.float32)  # packed-state rows
    pol = np.zeros((b, L, A), np.float32)
    for i in range(b):
        enc[i, :, 0] = start_val + i  # tag games for identification
        enc[i, :, 1] = np.arange(L)  # tag positions within the game
        pol[i, :, i % A] = 1.0
    m = np.zeros(b, bool)
    m[:n] = True
    if mask is not None:
        m = np.asarray(mask)
    return FinishedGames(
        states=jnp.asarray(enc),
        policy=jnp.asarray(pol),
        final_value=jnp.full((b,), 1.0) * (start_val + jnp.arange(b)),
        length=jnp.full((b,), length, jnp.int32),
        game_type=jnp.zeros(b, jnp.int32),
        mask=jnp.asarray(m),
    )


def test_add_and_counts():
    buf = create_buffer(4, L, D, A)
    buf = add_games(buf, _finished(2))
    assert int(buf.num_games) == 2
    assert int(buf.num_positions) == 10
    assert int(buf.ptr) == 2


def test_masked_rows_dropped():
    buf = create_buffer(4, L, D, A)
    fin = _finished(1, batch=3, mask=[False, True, False])
    buf = add_games(buf, fin)
    assert int(buf.num_games) == 1
    # The surviving game is row 1 (tag value 1.0).
    assert float(buf.states[0, 0, 0]) == 1.0


def test_ring_overwrites_oldest():
    buf = create_buffer(3, L, D, A)
    buf = add_games(buf, _finished(3, start_val=0))
    buf = add_games(buf, _finished(2, start_val=100))
    assert int(buf.games_added) == 5
    assert int(buf.num_games) == 3
    tags = sorted(float(buf.states[g, 0, 0]) for g in range(3))
    assert tags == [2.0, 100.0, 101.0]  # games 0,1 evicted


def test_value_target_is_static_final_value():
    buf = create_buffer(4, L, D, A)
    buf = add_games(buf, _finished(2, start_val=7.0))
    # game 0 final_value 7.0 broadcast over its 5 positions, zero beyond.
    np.testing.assert_allclose(np.asarray(buf.value[0, :5]), 7.0)
    np.testing.assert_allclose(np.asarray(buf.value[0, 5:]), 0.0)


def test_sample_returns_valid_positions():
    buf = create_buffer(8, L, D, A)
    buf = add_games(buf, _finished(3, length=4))
    enc, pol, val, gt = sample(buf, jax.random.key(0), 64)
    assert enc.shape == (64, D)
    # Every sampled policy is a real recorded one-hot (never a zero row).
    assert (np.asarray(pol).sum(axis=-1) > 0.99).all()


def test_late_heavy_weights_favor_recent():
    buf = create_buffer(8, L, D, A)
    for i in range(6):
        buf = add_games(buf, _finished(1, start_val=i))
    w = np.asarray(position_weights(buf, late_heavy=True))
    per_game = w.sum(axis=1)
    order = np.asarray(buf.seq)
    # weight strictly increases with insertion seq among filled slots
    filled = np.asarray(buf.length) > 0
    seqs, ws = order[filled], per_game[filled]
    assert (ws[np.argsort(seqs)] == np.sort(ws)).all()
    assert ws.max() > ws.min()


def test_truncate_to_seq_partial_load():
    """Partial load by step: only games that existed at the cut survive
    (ref ReplayBuffer.py:64-104 step_to_size_map)."""
    buf = create_buffer(8, L, D, A)
    buf = add_games(buf, _finished(3, start_val=0))  # seq 0,1,2 ("step 1")
    seq_at_step1 = int(buf.games_added)
    buf = add_games(buf, _finished(2, start_val=100))  # seq 3,4 ("step 2")

    cut = truncate_to_seq(buf, seq_at_step1)
    assert int(cut.num_games) == 3
    assert int(cut.games_added) == 3
    assert int(cut.ptr) == 3  # next insertion continues where step 1 left off
    kept = np.asarray(cut.seq)[np.asarray(cut.length) > 0]
    assert sorted(kept.tolist()) == [0, 1, 2]
    # Sampling never draws a dropped game (tags >= 100).
    enc, _, _, _ = sample(cut, jax.random.key(0), 128)
    assert (np.asarray(enc)[:, 0] < 100).all()
    # Inserting after the cut reuses the ring exactly as at step 1.
    cut = add_games(cut, _finished(1, start_val=200))
    assert int(cut.games_added) == 4


def test_truncate_to_seq_overwritten_slots_stay_empty():
    """Games evicted by post-cut insertions are unrecoverable — their slots
    stay empty (ref: partial load valid until the window first overflows)."""
    buf = create_buffer(3, L, D, A)
    buf = add_games(buf, _finished(3, start_val=0))  # fills ring: seq 0,1,2
    buf = add_games(buf, _finished(2, start_val=100))  # evicts seq 0,1
    cut = truncate_to_seq(buf, 3)
    kept = np.asarray(cut.seq)[np.asarray(cut.length) > 0]
    assert sorted(kept.tolist()) == [2]  # 0 and 1 are gone for good


def test_sample_without_replacement_unique():
    buf = create_buffer(4, L, D, A)
    buf = add_games(buf, _finished(4, length=9))
    # 36 valid positions; draw 20 unique
    enc, pol, val, gt = sample(
        buf, jax.random.key(1), 20, with_replacement=False
    )
    pos = np.asarray(enc)
    assert len(np.unique(pos, axis=0)) == 20


def test_epoch_permutation_valid_first_and_complete():
    from nuzero.training.replay import epoch_permutation

    buf = create_buffer(4, L, D, A)
    buf = add_games(buf, _finished(3, length=5))
    n_valid = int(buf.num_positions)
    perm = np.asarray(epoch_permutation(buf, jax.random.key(0)))
    assert sorted(perm.tolist()) == list(range(4 * L))  # a true permutation
    lengths = np.asarray(buf.length)
    valid_flat = {
        g * L + p for g in range(4) for p in range(int(lengths[g]))
    }
    assert set(perm[:n_valid].tolist()) == valid_flat  # valid slots first
    # Different keys give different orders (shuffle, not a fixed sort).
    perm2 = np.asarray(epoch_permutation(buf, jax.random.key(1)))
    assert perm[:n_valid].tolist() != perm2[:n_valid].tolist()


def test_epoch_permutation_game_type_filter():
    from nuzero.training.replay import epoch_permutation, gather

    buf = create_buffer(4, L, D, A)
    f = _finished(4, length=5)
    f = f.replace(game_type=jnp.asarray([0, 1, 0, 1], jnp.int32))
    buf = add_games(buf, f)
    perm = np.asarray(epoch_permutation(buf, jax.random.key(0), game_type=1))
    n_t1 = int(jnp.where(buf.game_type == 1, buf.length, 0).sum())
    games = perm[:n_t1] // L
    assert set(games.tolist()) == {1, 3}
    _, _, _, gt = gather(buf, jnp.asarray(perm[:n_t1]))
    assert (np.asarray(gt) == 1).all()
