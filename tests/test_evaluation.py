"""Evaluation layer: arena, agents, TestManager sweeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.envs import TicTacToe
from nuzero.evaluation import (
    GoalRushAgent,
    MctsAgent,
    PolicyAgent,
    RandomAgent,
    TestManager,
)
from nuzero.networks import MLPNetwork, NetworkManager, RecurrentNet
from nuzero.search import SearchParams

ENV = TicTacToe()


@pytest.fixture(scope="module")
def tm():
    return TestManager(ENV)


def test_random_vs_random(tm):
    stats = tm.run_test_batch(
        64, RandomAgent(), RandomAgent(), jax.random.key(0), show_results=False
    )
    assert stats.p0_wins + stats.p1_wins + stats.draws == 64
    # First mover wins most random TTT games.
    assert stats.p0_wins > stats.p1_wins


def test_mcts_beats_random(tm):
    mgr = NetworkManager(MLPNetwork(out_features=9), ENV.observation_shape)
    agent = MctsAgent(
        mgr, mgr.init(jax.random.key(0)), SearchParams(num_simulations=64)
    )
    s = tm.run_test_batch(
        32, agent, RandomAgent(), jax.random.key(1), show_results=False
    )
    assert s.p0_win_rate + s.draw_rate >= 0.9  # near-total non-loss
    assert s.p0_win_rate > 0.5
    s2 = tm.run_test_batch(
        32, RandomAgent(), agent, jax.random.key(2), show_results=False
    )
    assert s2.p1_win_rate + s2.draw_rate >= 0.8


def test_agent_cache_serves_host_play(tm):
    """Per-agent inference caches are consulted on host-driven play and
    cleared by the setters (ref Testing YAML Cache section +
    MctsAgent.py:59-65)."""
    from nuzero.utils.caches import DictCache

    mgr = NetworkManager(MLPNetwork(out_features=9), ENV.observation_shape)
    variables = mgr.init(jax.random.key(5))
    agent = PolicyAgent(mgr, variables)
    agent.set_cache(DictCache(max_size=64))

    out1 = tm.run_visual_test(agent, RandomAgent(), seed=0)
    assert agent.cache.length() > 0
    assert agent.cache.misses > 0
    # Replaying the same seed hits the memo for every P0 decision.
    hits_before = agent.cache.hits
    out2 = tm.run_visual_test(agent, RandomAgent(), seed=0)
    assert agent.cache.hits > hits_before
    assert out2["actions"] == out1["actions"]
    # Network change invalidates the memo (ref setter semantics).
    agent.set_network(mgr.init(jax.random.key(6)))
    assert agent.cache.length() == 0


def test_create_agent_from_config_wires_cache(tm):
    mgr = NetworkManager(MLPNetwork(out_features=9), ENV.observation_shape)
    agent = tm.create_agent_from_config(
        {
            "agent_type": "policy",
            "Network": {"recurrent_iterations": 2, "load_checkpoint": False},
            "Cache": {"cache_choice": "keyless", "max_size": 256,
                      "keep_updated": False},
        },
        manager=mgr,
    )
    assert agent.cache is not None
    assert agent.cache.max_length() == 256


def test_policy_agent_legal_and_deterministic(tm):
    mgr = NetworkManager(MLPNetwork(out_features=9), ENV.observation_shape)
    agent = PolicyAgent(mgr, mgr.init(jax.random.key(3)))
    s = tm.run_test_batch(
        16, agent, RandomAgent(), jax.random.key(4), show_results=False
    )
    assert s.num_games == 16  # all games completed with legal moves


def test_iterations_sweep(tm):
    mgr = NetworkManager(
        RecurrentNet(policy_channels=1, num_filters=8, num_blocks=1),
        ENV.observation_shape,
    )
    variables = mgr.init(jax.random.key(5))
    cfg = {
        "Test": {
            "test_type": "data",
            "Data": {
                "Variable": {
                    "changing_agent": 1,
                    "changing_parameter": {
                        "name": "iterations",
                        "Range": {"first": 1, "last": 3, "step": 1},
                    },
                },
                "Runs": {"num_runs": 1, "num_games_per_run": 8},
                "Testers": {"new_testers": True, "num_testers": 4},
            },
        },
        "Agents": {
            "p1_agent": {
                "agent_type": "policy",
                "Network": {"recurrent_iterations": 1, "load_checkpoint": False},
            },
            "p2_agent": {"agent_type": "random"},
        },
    }
    results = tm.test_from_config(cfg, manager=mgr)
    assert [v for v, _ in results] == [1, 2, 3]
    for _, (p0, p1, dr) in results:
        assert abs(p0 + p1 + dr - 1.0) < 1e-6


def test_visual_test(tm):
    res = tm.run_visual_test(RandomAgent(), RandomAgent(), seed=1)
    assert 5 <= res["length"] <= 9
    assert res["terminal_value"] in (-1.0, 0.0, 1.0)


def test_goal_rush_on_scs():
    from nuzero.envs.scs import SCSGame, load_scenario

    scn = load_scenario(
        "/root/reference/Games/SCS/Game_configs/solo_soldier_config_5.yml",
        seed=3,
    )
    env = SCSGame(scn)
    tm = TestManager(env)
    # p1 (player 1) owns the only unit; goal rush should reach p0's VP.
    s = tm.run_test_batch(
        16, RandomAgent(), GoalRushAgent(), jax.random.key(0), show_results=False
    )
    assert s.p1_win_rate >= 0.9
    # Random wanderer wins far less often.
    s2 = tm.run_test_batch(
        16, RandomAgent(), RandomAgent(), jax.random.key(1), show_results=False
    )
    assert s2.p1_win_rate <= s.p1_win_rate


def test_board_size_sweep():
    """board_size changing-parameter: env rebuilt per size via
    env_factory, both agents replayed on it (the size-transfer machinery,
    ref Plots/sizes experiments done by hand per-size)."""
    import math
    import os

    from nuzero.envs.scs import SCSGame, load_scenario

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "scenarios", "solo_scout_5.yml",
    )

    sizes_seen = []

    def env_factory(size):
        env = SCSGame(load_scenario(
            path, seed=1, board_size=size,
            turns=math.ceil(7 * size / 5),
        ))
        sizes_seen.append((size, env.R, env.C))
        return env

    env5 = env_factory(4)
    mgr = NetworkManager(
        RecurrentNet(
            policy_channels=env5.action_space_shape[0],
            num_filters=8, num_blocks=1, hex=True,
        ),
        env5.observation_shape,
    )
    tm = TestManager(env5, 8)
    cfg = {
        "Test": {
            "test_type": "data",
            "Data": {
                "Variable": {
                    "changing_agent": 2,
                    "changing_parameter": {
                        "name": "board_size",
                        "Range": {"first": 4, "last": 6, "step": 2},
                    },
                },
                "Runs": {"num_runs": 1, "num_games_per_run": 8},
            },
        },
        "Agents": {
            "p1_agent": {"agent_type": "random"},
            "p2_agent": {
                "agent_type": "policy",
                "Network": {"recurrent_iterations": 2,
                            "load_checkpoint": False},
            },
        },
    }
    results = tm.test_from_config(cfg, manager=mgr, env_factory=env_factory)
    assert [v for v, _ in results] == [4, 6]
    # The env really changed shape per point (same params, re-jitted).
    assert (4, 4, 4) in sizes_seen and (6, 6, 6) in sizes_seen
    for _, (p0, p1, dr) in results:
        assert abs(p0 + p1 + dr - 1.0) < 1e-6

    # GoalRush (whose distance fields depend on the board) also survives
    # a size change.
    s = tm.run_test_batch(
        8, RandomAgent(), GoalRushAgent(), jax.random.key(0),
        show_results=False,
    )
    assert s.num_games == 8
