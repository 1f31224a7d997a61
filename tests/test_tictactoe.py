"""Tic-Tac-Toe env unit tests: rules, masks, terminal invariants.

The reference ships no unit tests of game rules (SURVEY §4); these validate
the pure-JAX engine against an independent, deliberately-naive Python oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.envs import TicTacToe


class OracleTTT:
    """Slow, obvious tic-tac-toe for cross-checking (players 0/1)."""

    def __init__(self):
        self.board = [[0] * 3 for _ in range(3)]
        self.length = 0
        self.player = 0
        self.terminal = False
        self.value = 0.0

    def legal(self):
        if self.terminal:
            return [False] * 9
        return [self.board[i // 3][i % 3] == 0 for i in range(9)]

    def step(self, a):
        r, c = a // 3, a % 3
        mark = self.player + 1
        self.board[r][c] = mark
        self.length += 1
        lines = (
            [[(i, j) for j in range(3)] for i in range(3)]
            + [[(j, i) for j in range(3)] for i in range(3)]
            + [[(i, i) for i in range(3)], [(i, 2 - i) for i in range(3)]]
        )
        won = any(all(self.board[r][c] == mark for r, c in ln) for ln in lines)
        if won:
            self.terminal = True
            self.value = 1.0 if mark == 1 else -1.0
        elif self.length == 9:
            self.terminal = True
            self.value = 0.0
        self.player = self.length % 2


@pytest.fixture(scope="module")
def env():
    return TicTacToe()


def test_initial_state(env):
    s = env.init(jax.random.key(0))
    assert int(s.current_player) == 0
    assert not bool(env.terminal(s))
    assert env.legal_mask(s).sum() == 9
    np.testing.assert_array_equal(np.asarray(env.observe(s)), np.zeros((2, 3, 3)))


def test_p0_row_win(env):
    s = env.init(None)
    for a in [0, 3, 1, 4, 2]:  # p0 takes top row
        s = env.step(s, jnp.int32(a))
    assert bool(s.terminal)
    assert float(s.terminal_value) == 1.0
    assert env.legal_mask(s).sum() == 0


def test_p1_col_win(env):
    s = env.init(None)
    for a in [0, 2, 1, 5, 4, 8]:  # p1 takes right column
        s = env.step(s, jnp.int32(a))
    assert bool(s.terminal)
    assert float(s.terminal_value) == -1.0


def test_draw(env):
    s = env.init(None)
    for a in [0, 1, 2, 4, 3, 5, 7, 6, 8]:
        s = env.step(s, jnp.int32(a))
    assert bool(s.terminal)
    assert float(s.terminal_value) == 0.0
    assert int(s.length) == 9


def test_random_playouts_match_oracle(env):
    """200 random full games, lockstep comparison against the oracle."""
    step = jax.jit(env.step)
    rng = np.random.default_rng(439)
    for _ in range(200):
        s = env.init(None)
        oracle = OracleTTT()
        while not oracle.terminal:
            legal_j = np.asarray(env.legal_mask(s))
            assert legal_j.tolist() == oracle.legal()
            assert int(s.current_player) == oracle.player
            a = rng.choice(np.flatnonzero(legal_j))
            s = step(s, jnp.int32(a))
            oracle.step(int(a))
        assert bool(s.terminal)
        assert float(s.terminal_value) == oracle.value


def test_vmapped_steps(env):
    """Batched stepping is consistent with single-game stepping."""
    batch = 64
    keys = jax.random.split(jax.random.key(1), batch)
    states = jax.vmap(lambda k: env.init(k))(keys)
    rng = np.random.default_rng(7)
    actions = jnp.asarray(rng.integers(0, 9, size=batch), jnp.int32)
    stepped = jax.vmap(env.step)(states, actions)
    single = env.step(env.init(None), actions[3])
    np.testing.assert_array_equal(
        np.asarray(stepped.board[3]), np.asarray(single.board)
    )


def test_observation_planes(env):
    s = env.init(None)
    s = env.step(s, jnp.int32(4))  # p0 center
    s = env.step(s, jnp.int32(0))  # p1 corner
    obs = np.asarray(env.observe(s))
    assert obs[0, 1, 1] == 1.0 and obs[0].sum() == 1.0
    assert obs[1, 0, 0] == 1.0 and obs[1].sum() == 1.0
