"""Integrated multi-device coordinator: AlphaZero.run on a dp mesh.

The reference scales by spreading Gamer Ray actors over cluster nodes with a
single-process learner (ref ``Training/AlphaZero.py:525-577``,
``Training/Gamer.py:17``).  Here the SAME coordinator — early fill,
sequential/async modes, checkpoints, journal, in-loop eval — runs with the
self-play batch and replay game axis sharded over an 8-device mesh and
replicated params (SURVEY §2.8).
"""

import json
import os

import jax
import numpy as np
import pytest

from nuzero.config.schemas import (
    LearningConfig,
    RunningConfig,
    SavingConfig,
    TestingFrequencyConfig,
    TrainingConfig,
)
from nuzero.envs import TicTacToe
from nuzero.networks import MLPNetwork, NetworkManager
from nuzero.parallel import make_mesh, replicate, shard_batch
from nuzero.search import SearchParams
from nuzero.training import AlphaZero

from conftest import cpu_devices


def _make_az(run_dir, mesh, training_steps=3, mode="sequential"):
    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=16,
            training_steps=training_steps,
            num_games_per_type_per_step=2,
            running_mode=mode,
            early_fill_per_type=4,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=1
        ),
        testing=TestingFrequencyConfig(
            policy_test_frequency=2,
            mcts_test_frequency=0,
            num_policy_test_games=8,
            testing_actors=8,
        ),
        saving=SavingConfig(save_frequency=2, save_buffer=True),
    )
    return AlphaZero(
        env, mgr, cfg, SearchParams(num_simulations=8),
        run_dir=run_dir, mesh=mesh,
    )


def test_mesh_coordinator_trains_checkpoints_and_resumes(tmp_path):
    mesh = make_mesh(cpu_devices())
    assert mesh.size == 8
    run_dir = str(tmp_path / "mesh_run")
    os.makedirs(run_dir)
    az = _make_az(run_dir, mesh)
    state = az.run(seed=0)

    # 3 coordinator steps with finite loss, journaled.
    lines = [
        json.loads(l)
        for l in open(os.path.join(run_dir, "journal.jsonl"))
    ]
    assert [l["step"] for l in lines] == [1, 2, 3]
    assert all(np.isfinite(l["loss/combined"]) for l in lines)
    # In-loop eval ran on the mesh path too (step 2).
    assert "wr/policy_as_p0" in lines[1]

    # Shardings: params replicated, replay game axis dp-sharded.
    leaf = jax.tree.leaves(state.params)[0]
    assert leaf.sharding.is_equivalent_to(replicate(mesh), leaf.ndim)
    assert az.buffer.states.sharding.is_equivalent_to(
        shard_batch(mesh), az.buffer.states.ndim
    )

    # Resume from the step-2 checkpoint on the same mesh and keep training.
    az2 = _make_az(run_dir, mesh, training_steps=3)
    state2, step = az2.load("auto")
    assert step == 2
    assert int(az2.buffer.num_games) > 0  # buffer restored
    state2 = az2.run(seed=1, initial_state=state2, starting_step=step)
    assert int(state2.step) > 0
    lines = [
        json.loads(l)
        for l in open(os.path.join(run_dir, "journal.jsonl"))
    ]
    assert lines[-1]["step"] == 3


def test_mesh_rejects_indivisible_batch(tmp_path):
    mesh = make_mesh(cpu_devices()[:4])
    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(running=RunningConfig(num_actors=6))
    with pytest.raises(ValueError, match="num_actors"):
        AlphaZero(env, mgr, cfg, SearchParams(num_simulations=4), mesh=mesh)
