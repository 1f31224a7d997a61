"""End-to-end AlphaZero pipeline tests (the reference's short/continue
training system tests — ``System_Tests/Training/`` — with real assertions)."""

import json
import os

import jax
import numpy as np
import pytest

from nuzero.config.schemas import (
    LearningConfig,
    OptimizerConfig,
    RunningConfig,
    SavingConfig,
    TrainingConfig,
)
from nuzero.envs import TicTacToe
from nuzero.networks import MLPNetwork, NetworkManager
from nuzero.search import SearchParams
from nuzero.training import AlphaZero

import dataclasses


def _setup(tmp_path, steps=4, save_frequency=2):
    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        network_name="test_net",
        running=RunningConfig(
            num_actors=8,
            training_steps=steps,
            num_games_per_type_per_step=4,
            early_fill_per_type=8,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=2
        ),
        optimizer=OptimizerConfig(starting_lr=1e-3),
        saving=SavingConfig(save_frequency=save_frequency),
    )
    search = SearchParams(num_simulations=8)
    az = AlphaZero(env, mgr, cfg, search, run_dir=str(tmp_path))
    return az


def test_short_training_run(tmp_path):
    az = _setup(tmp_path)
    state = az.run(seed=0)
    assert int(state.step) == 4 * 2  # steps * num_samples updates

    records = az.journal.load()
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    for r in records:
        assert np.isfinite(r["loss/combined"])
        assert r["games"] >= 4
    assert int(az.buffer.num_games) >= 8 + 4 * 4

    ckpts = os.listdir(tmp_path / "checkpoints")
    assert "step_00000002" in ckpts and "step_00000004" in ckpts


def test_continue_training(tmp_path):
    az = _setup(tmp_path, steps=2)
    az.run(seed=0)

    # Fresh coordinator resuming from the checkpoint (ref
    # continue_training_test.py).
    az2 = _setup(tmp_path, steps=4)
    state, step = az2.load("auto")
    assert step == 2
    assert int(az2.buffer.num_games) > 0  # buffer restored
    state = az2.run(seed=1, initial_state=state, starting_step=step)
    records = az2.journal.load()
    assert [r["step"] for r in records] == [1, 2, 3, 4]


def test_asynchronous_mode(tmp_path):
    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8,
            training_steps=3,
            running_mode="asynchronous",
            early_fill_per_type=8,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=1
        ),
    )
    az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=8), run_dir=None)
    state = az.run(seed=0)
    assert int(state.step) == 3


def test_keep_scheduler_switch(tmp_path):
    """keep_scheduler resumes or restarts the LR schedule independently of
    the optimizer moments (ref AlphaZero.py:110-146)."""
    import optax

    az = _setup(tmp_path, steps=2)
    az.run(seed=0)

    def schedule_counts(opt_state):
        return [
            int(n.count)
            for n in jax.tree.leaves(
                opt_state,
                is_leaf=lambda n: isinstance(n, optax.ScaleByScheduleState),
            )
            if isinstance(n, optax.ScaleByScheduleState)
        ]

    # Default (keep_scheduler=False): fresh schedule at count 0.
    az2 = _setup(tmp_path, steps=2)
    state, step = az2.load("auto")
    assert schedule_counts(state.opt_state) == [0]

    # keep_scheduler=True: schedule resumes at the restored update count.
    az3 = _setup(tmp_path, steps=2)
    az3.cfg = dataclasses.replace(
        az3.cfg,
        checkpoint=dataclasses.replace(az3.cfg.checkpoint, keep_scheduler=True),
    )
    state, step = az3.load("auto")
    assert schedule_counts(state.opt_state) == [int(state.step)]
    assert int(state.step) > 0


def test_partial_buffer_load_by_step(tmp_path):
    """Resuming at step N samples only games that existed then, even when
    the buffer comes from a newer checkpoint (ref ReplayBuffer.py:80-104)."""
    az = _setup(tmp_path, steps=4, save_frequency=2)
    az.run(seed=0)
    records = az.journal.load()
    seq_at_2 = next(r["buffer_seq"] for r in records if r["step"] == 2)

    az2 = _setup(tmp_path, steps=4)
    assert az2.load_buffer_at_step(2)
    # Buffer holds exactly the games inserted up to step 2 (ring capacity
    # 64 was never overflowed here).
    assert int(az2.buffer.games_added) == seq_at_2
    seqs = np.asarray(az2.buffer.seq)
    assert seqs.max() == seq_at_2 - 1


def test_asynchronous_update_delay(tmp_path):
    """update_delay decouples learner rate from actor rate: each train step
    keeps playing move-batches until the delay has elapsed (ref
    AlphaZero.py:389-404,468-469,1259-1266)."""
    import time

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8,
            training_steps=2,
            running_mode="asynchronous",
            update_delay=0.3,
            early_fill_per_type=8,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=1
        ),
    )
    az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=8), run_dir=None)
    t0 = time.time()
    state = az.run(seed=0)
    assert int(state.step) == 2
    assert time.time() - t0 >= 2 * 0.3  # each step waited out the delay


def test_asynchronous_testing_and_early_testing(tmp_path):
    """asynchronous_testing runs eval batches on a worker thread, harvested
    into the journal under their launch step; early_testing evaluates the
    untrained net at step 0 (ref RemoteTestManager +
    AlphaZero.py:347-349,1268-1280)."""
    from nuzero.config.schemas import TestingFrequencyConfig

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8,
            training_steps=3,
            num_games_per_type_per_step=2,
            early_fill_per_type=8,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=1
        ),
        testing=TestingFrequencyConfig(
            asynchronous_testing=True,
            early_testing=True,
            policy_test_frequency=2,
            mcts_test_frequency=0,
            num_policy_test_games=8,
            testing_actors=8,
        ),
    )
    az = AlphaZero(
        env, mgr, cfg, SearchParams(num_simulations=8), run_dir=str(tmp_path)
    )
    az.run(seed=0)
    records = az.journal.load()
    # Train-loop records never carry eval results inline (non-blocking)...
    train_records = [r for r in records if not r.get("async_test")]
    assert not any("wr/policy_as_p0" in r for r in train_records)
    # ...eval results arrive as separate records tagged with their step:
    # step 0 (early_testing) and step 2 (policy_test_frequency).
    async_steps = sorted(r["step"] for r in records if r.get("async_test"))
    assert async_steps == [0, 2]
    for r in records:
        if r.get("async_test"):
            assert 0.0 <= r["wr/policy_as_p0"] <= 1.0


def test_value_probe_state_set(tmp_path):
    """State-set value probes land in the journal at plot frequency
    (ref AlphaZero.py:1175-1179)."""
    import jax.numpy as jnp

    from nuzero.config.schemas import PlottingConfig

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8,
            training_steps=4,
            num_games_per_type_per_step=2,
            early_fill_per_type=8,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=16, num_samples=1
        ),
        plotting=PlottingConfig(plot_frequency=2),
    )
    probes = jnp.zeros((3,) + env.observation_shape, jnp.float32)
    az = AlphaZero(
        env,
        mgr,
        cfg,
        SearchParams(num_simulations=8),
        run_dir=str(tmp_path),
        state_set=probes,
    )
    az.run(seed=0)
    records = az.journal.load()
    probed = [r for r in records if "value_probe/0" in r]
    assert [r["step"] for r in probed] == [2, 4]
    for r in probed:
        for i in range(3):
            v = r[f"value_probe/{i}"]
            assert np.isfinite(v) and -1.0 <= v <= 1.0


def test_epochs_method_sweeps_every_position_exactly(tmp_path):
    """learning_method=epochs visits every valid buffer position exactly
    learning_epochs times per training step (exact shuffle-and-sweep,
    ref AlphaZero.py:686-737)."""
    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8, training_steps=1,
            num_games_per_type_per_step=4, early_fill_per_type=8,
        ),
        learning=LearningConfig(
            replay_window_size=64,
            learning_method="epochs",
            epochs_batch_size=4,
            learning_epochs=2,
        ),
        optimizer=OptimizerConfig(starting_lr=1e-3),
    )
    az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=4), run_dir=None)
    state = az.learner.init_state(jax.random.key(0))
    # Fill the buffer with games whose position count divides the batch
    # size so the sweep is exact (the remainder is dropped otherwise, as in
    # the reference's replay_size // batch_size slicing).
    from nuzero.training.replay import FinishedGames

    B, L, Dd, A = 8, env.max_game_length, az.state_dim, env.num_actions
    fin = FinishedGames(
        states=jax.numpy.zeros((B, L, Dd)),
        policy=jax.numpy.ones((B, L, A)) / A,
        final_value=jax.numpy.zeros(B),
        length=jax.numpy.full(B, 4, jax.numpy.int32),  # 8*4 = 32 positions
        game_type=jax.numpy.zeros(B, jax.numpy.int32),
        mask=jax.numpy.ones(B, bool),
    )
    az.buffer = az.add_games(az.buffer, fin)
    assert int(az.buffer.num_positions) == 32

    seen = []
    orig = az._epoch_samplers[0]

    def spy(buffer, idx):
        seen.append(np.asarray(idx))
        return orig(buffer, idx)

    az._epoch_samplers[0] = spy
    az._train_once(state, jax.random.key(1))

    flat = np.concatenate(seen)
    assert len(flat) == 2 * 32  # 2 epochs x 32 positions
    counts = np.bincount(flat, minlength=az.buffer.capacity * L)
    lengths = np.asarray(az.buffer.length)
    for g in range(az.buffer.capacity):
        for p in range(L):
            expected = 2 if p < lengths[g] else 0
            assert counts[g * L + p] == expected


def test_weight_stats_and_auto_plots(tmp_path):
    """plot_weights emits the |w| max/min/mean series (ref
    AlphaZero.py:1164-1173) and a fresh run leaves rendered plots in
    run_dir/plots with no manual step."""
    from nuzero.config.schemas import PlottingConfig

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=8, training_steps=2,
            num_games_per_type_per_step=2, early_fill_per_type=4,
        ),
        learning=LearningConfig(
            replay_window_size=64, batch_size=8, num_samples=1
        ),
        plotting=PlottingConfig(plot_weights=True, plot_frequency=1),
        saving=SavingConfig(save_frequency=100),  # no mid-run checkpoint
        optimizer=OptimizerConfig(starting_lr=1e-3),
    )
    az = AlphaZero(
        env, mgr, cfg, SearchParams(num_simulations=4), run_dir=str(tmp_path)
    )
    az.run(seed=0)
    recs = az.journal.load()
    stepped = [r for r in recs if "weights/abs_max" in r]
    assert stepped, "plot_weights should journal weight stats"
    r = stepped[-1]
    # min can be exactly 0 (zero-initialized biases).
    assert 0 <= r["weights/abs_min"] <= r["weights/abs_mean"] <= r["weights/abs_max"]
    assert r["weights/abs_max"] > 0
    plots_dir = os.path.join(str(tmp_path), "plots")
    names = set(os.listdir(plots_dir))
    assert "loss_global.png" in names and "loss_recent.png" in names
    assert "weights.png" in names


def test_plot_loss_off_skips_loss_plots(tmp_path):
    from nuzero.utils.plots import plot_training_run

    records = [
        {"step": i, "loss/combined": 1.0 / (i + 1), "step_time_s": 0.1}
        for i in range(3)
    ]
    written = plot_training_run(
        records, str(tmp_path / "p"), include_loss=False
    )
    assert not any("loss" in os.path.basename(p) for p in written)


def test_plots_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    """matplotlib is optional: without it the plot set is skipped with one
    printed line, never silently."""
    from nuzero.utils import plots

    monkeypatch.setattr(plots, "plt", None)
    written = plots.plot_training_run([{"step": 1, "loss/combined": 1.0}], str(tmp_path))
    assert written == []
    assert "plots skipped" in capsys.readouterr().out
    assert plots.plot_size_sweep({}, str(tmp_path / "s.png")) is None
