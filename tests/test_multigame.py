"""Multi-game-type training: one network, several envs, per-type recurrent
iteration counts (ref game_args_list + per-type Gamer pools + recurrent
game-index bucketing, ``Training/AlphaZero.py:233-235,525-577,846-870``)."""

import numpy as np
import pytest

from nuzero.config.schemas import (
    LearningConfig,
    RecurrentOptions,
    RunningConfig,
    TestingFrequencyConfig,
    TrainingConfig,
)
from nuzero.envs import TicTacToe
from nuzero.networks import NetworkManager, RecurrentNet
from nuzero.search import SearchParams
from nuzero.training import AlphaZero


def test_two_game_types_with_distinct_iterations(tmp_path):
    envs = [TicTacToe(), TicTacToe()]  # two game types, shared shapes
    mgr = NetworkManager(
        RecurrentNet(policy_channels=1, num_filters=8, num_blocks=1, hex=False),
        envs[0].observation_shape,
    )
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8,
            training_steps=2,
            num_games_per_type_per_step=2,
            early_fill_per_type=4,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=1
        ),
        recurrent=RecurrentOptions(
            train_iterations=(1, 3), pred_iterations=(1, 2)
        ),
        testing=TestingFrequencyConfig(
            policy_test_frequency=0, mcts_test_frequency=0
        ),
    )
    az = AlphaZero(
        envs, mgr, cfg, SearchParams(num_simulations=4), run_dir=str(tmp_path)
    )
    # Per-type train iterations threaded into the learner.
    assert az.learner.config.train_iterations_per_type == (1, 3)

    state = az.run(seed=0)
    records = az.journal.load()
    assert len(records) == 2
    for r in records:
        assert np.isfinite(r["loss/combined"])
        assert np.isfinite(r["loss/type0"]) and np.isfinite(r["loss/type1"])
        # Both types contribute games every step (2 per type).
        assert r["games"] >= 4

    # The buffer holds games of both types.
    types = set(
        np.asarray(az.buffer.game_type)[np.asarray(az.buffer.length) > 0]
        .tolist()
    )
    assert types == {0, 1}


def test_mismatched_shapes_rejected():
    from nuzero.envs.scs import SCSGame, load_scenario

    scn = load_scenario(
        "/root/repo/configs/scenarios/open_field_5.yml", seed=1
    )
    envs = [TicTacToe(), SCSGame(scn)]
    mgr = NetworkManager(
        RecurrentNet(policy_channels=1, num_filters=8, num_blocks=1, hex=False),
        envs[0].observation_shape,
    )
    with pytest.raises(ValueError, match="share observation"):
        AlphaZero(envs, mgr, TrainingConfig(), SearchParams(num_simulations=4))
