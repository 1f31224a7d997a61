"""State-set probe builders (ref ``Run.py:427-579`` +
``SCS_Game.set_simple_game_state``, SCS_Game.py:948-978)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.envs.scs import SCSGame, load_scenario
from nuzero.evaluation.state_sets import (
    MIRRORED_SPECS,
    SOLO_SPECS,
    build_state_set,
    mirrored_state_set,
    r_unbalanced_state_set,
    solo_state_set,
    unbalanced_state_set,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def open_field():
    return SCSGame(
        load_scenario(
            os.path.join(REPO, "configs", "scenarios", "open_field_5.yml"),
            seed=3,
        )
    )


@pytest.fixture(scope="module")
def solo():
    return SCSGame(
        load_scenario(
            os.path.join(REPO, "configs", "scenarios", "solo_scout_5.yml"),
            seed=3,
        )
    )


def test_simple_state_places_units(open_field):
    g = open_field
    st = g.simple_state(9, [(1, 0, 1), (1, 1, 1), (0, 0, 0)])
    assert int(st.alive.sum()) == 3
    assert int(st.turn) == 9
    assert not bool(st.terminal)
    # Unit table: player-1 units occupy slots S..; player-0 slot 0.
    alive = np.asarray(st.alive)
    assert alive[0] and alive[g.S] and alive[g.S + 1]
    # Board occupancy matches placements.
    board = np.asarray(st.board)
    assert board[0, 1, 0] == g.S and board[1, 1, 0] == g.S + 1
    assert board[0, 0, 0] == 0
    # Probe states must offer a decision (legal action exists).
    assert bool(g.legal_mask(st).any())


def test_simple_state_stacking(open_field):
    g = open_field
    st = g.simple_state(9, [(1, 0, 1), (1, 0, 1)])
    board = np.asarray(st.board)
    assert board[0, 1, 0] == g.S and board[0, 1, 1] == g.S + 1


def test_simple_state_overflow_raises(solo):
    with pytest.raises(ValueError):
        # solo scenario has 1 unit slot per player
        solo.simple_state(7, [(1, 0, 0), (1, 1, 1)])


def test_mirrored_and_unbalanced_sets_shapes(open_field):
    for builder in (
        mirrored_state_set,
        unbalanced_state_set,
        r_unbalanced_state_set,
    ):
        obs = builder(open_field)
        assert obs.shape == (6,) + open_field.observation_shape
        assert bool(jnp.isfinite(obs).all())


def test_solo_set(solo):
    obs = solo_state_set(solo)
    assert obs.shape == (6,) + solo.observation_shape
    assert bool(jnp.isfinite(obs).all())
    # Each solo probe has exactly one live unit (player 1's scout):
    # the two unit-stat blocks differ between probes only via position.
    base = build_state_set(solo, SOLO_SPECS[:1])
    assert not bool(jnp.allclose(obs[0], obs[5]))
    assert bool(jnp.allclose(obs[0], base[0]))


def test_probe_states_distinct(open_field):
    obs = build_state_set(open_field, MIRRORED_SPECS)
    flat = np.asarray(obs).reshape(len(MIRRORED_SPECS), -1)
    for i in range(len(flat)):
        for j in range(i + 1, len(flat)):
            assert not np.allclose(flat[i], flat[j]), (i, j)
