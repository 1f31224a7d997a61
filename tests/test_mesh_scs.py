"""The FLAGSHIP stack (SCS + hex-conv RecurrentNet) on a device mesh and
across host processes.

The reference demonstrably trained SCS across cluster nodes (SLURM boots
the Ray head + workers and SPREADs Gamers,
ref ``SLURM/slurm-template.sh:52-63``, ``Training/Gamer.py:17``; its
shipped SCS models under ``Games/SCS/models/`` came from those runs).
The round-4 multi-device proofs all used TTT+MLP; these tests run the
integrated coordinator with the SCS-specific hazards engaged:

- ``SCSState`` pytree sharding over the dp mesh (struct-of-arrays env
  state with mixed ranks/dtypes),
- the hex-conv trunk under a CPU mesh (activations sharded over dp),
- per-game ``randomize_vp`` keys across shards (each shard's games must
  draw their own victory-point layouts).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np

from nuzero.config.schemas import (
    LearningConfig,
    RunningConfig,
    SavingConfig,
    TestingFrequencyConfig,
    TrainingConfig,
)
from nuzero.envs.scs import SCSGame, load_scenario
from nuzero.networks import NetworkManager, RecurrentNet
from nuzero.parallel import make_mesh, replicate, shard_batch
from nuzero.search import SearchParams
from nuzero.training import AlphaZero

from conftest import cpu_devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = os.path.join(REPO, "configs", "scenarios", "solo_scout_5.yml")


def _make_scs_az(run_dir, mesh, training_steps=2):
    env = SCSGame(load_scenario(SCENARIO, seed=3), randomize_vp=True)
    mgr = NetworkManager(
        RecurrentNet(
            policy_channels=env.action_space_shape[0],
            num_filters=8,
            num_blocks=1,
            hex=True,
        ),
        env.observation_shape,
    )
    cfg = TrainingConfig(
        running=RunningConfig(
            num_actors=16,
            training_steps=training_steps,
            num_games_per_type_per_step=2,
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
        saving=SavingConfig(save_frequency=1, save_buffer=True),
    )
    return AlphaZero(
        env, mgr, cfg, SearchParams(num_simulations=6),
        run_dir=run_dir, mesh=mesh,
    )


def test_mesh_scs_coordinator_trains_checkpoints_and_resumes(tmp_path):
    mesh = make_mesh(cpu_devices())
    assert mesh.size == 8
    run_dir = str(tmp_path / "mesh_scs")
    os.makedirs(run_dir)
    az = _make_scs_az(run_dir, mesh)
    state = az.run(seed=0)

    lines = [
        json.loads(l) for l in open(os.path.join(run_dir, "journal.jsonl"))
    ]
    assert [l["step"] for l in lines] == [1, 2]
    assert all(np.isfinite(l["loss/combined"]) for l in lines)
    assert "wr/policy_as_p0" in lines[1]

    # Params replicated; the SCS replay (packed SCSState trajectories)
    # sharded on the game axis.
    leaf = jax.tree.leaves(state.params)[0]
    assert leaf.sharding.is_equivalent_to(replicate(mesh), leaf.ndim)
    assert az.buffer.states.sharding.is_equivalent_to(
        shard_batch(mesh), az.buffer.states.ndim
    )

    # randomize_vp drew DIFFERENT victory-point layouts across the sharded
    # self-play games: the vp planes in the buffered trajectories must not
    # all equal the scenario's static layout.  (Position of the vp planes
    # in the packed state is implementation detail; compare unpacked.)
    from nuzero.utils.packing import make_packer

    template = az.envs[0].init(jax.random.key(0))
    _, unpack, _ = make_packer(template)
    live = np.asarray(az.buffer.length) > 0
    first_states = np.asarray(az.buffer.states)[live, 0]
    vps = np.stack(
        [np.asarray(unpack(s).vp) for s in first_states[:16]]
    )
    assert len(np.unique(vps.reshape(vps.shape[0], -1), axis=0)) > 1, (
        "per-game VP randomization collapsed to one layout under sharding"
    )

    # Resume from the checkpoint on the same mesh.
    az2 = _make_scs_az(run_dir, mesh, training_steps=2)
    state2, step = az2.load("auto")
    assert step == 2
    assert int(az2.buffer.num_games) > 0


SCS_TRAIN_WORKER = r"""
import os, sys
sys.path.insert(0, %(repo)r)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from nuzero.parallel.distributed import initialize_distributed
initialize_distributed(%(coord)r, 2, int(sys.argv[1]))
import jax
import numpy as np
assert jax.process_count() == 2 and len(jax.devices()) == 4

from nuzero.config.schemas import (
    LearningConfig, RunningConfig, SavingConfig, TestingFrequencyConfig,
    TrainingConfig,
)
from nuzero.envs.scs import SCSGame, load_scenario
from nuzero.networks import NetworkManager, RecurrentNet
from nuzero.parallel import make_mesh, replicate, shard_batch
from nuzero.search import SearchParams
from nuzero.training import AlphaZero

run_dir = %(run_dir)r
scenario = os.path.join(%(repo)r, "configs", "scenarios", "solo_scout_5.yml")

env = SCSGame(load_scenario(scenario, seed=3), randomize_vp=True)
mgr = NetworkManager(
    RecurrentNet(
        policy_channels=env.action_space_shape[0],
        num_filters=8, num_blocks=1, hex=True,
    ),
    env.observation_shape,
)
cfg = TrainingConfig(
    running=RunningConfig(
        num_actors=16, training_steps=2,
        num_games_per_type_per_step=2, early_fill_per_type=4,
    ),
    learning=LearningConfig(
        replay_window_size=64, batch_size=16, num_samples=1
    ),
    testing=TestingFrequencyConfig(
        policy_test_frequency=2, mcts_test_frequency=0,
        num_policy_test_games=8, testing_actors=8,
    ),
    saving=SavingConfig(save_frequency=1, save_buffer=True),
)
mesh = make_mesh(jax.devices())
az = AlphaZero(
    env, mgr, cfg, SearchParams(num_simulations=6),
    run_dir=run_dir, mesh=mesh,
)
state = az.run(seed=0)

leaf = jax.tree.leaves(state.params)[0]
assert leaf.sharding.is_equivalent_to(replicate(mesh), leaf.ndim)
assert not leaf.is_fully_addressable
assert az.buffer.states.sharding.is_equivalent_to(
    shard_batch(mesh), az.buffer.states.ndim
)
assert not az.buffer.states.is_fully_addressable
assert int(state.step) == 2
host_leaf = np.asarray(leaf)
print("PARAM_SUM", float(np.abs(host_leaf).sum()), flush=True)

# Cross-process cooperative checkpoint -> resume.
az2 = AlphaZero(
    env, mgr, cfg, SearchParams(num_simulations=6),
    run_dir=run_dir, mesh=mesh,
)
state2, step = az2.load("auto")
assert step == 2, step
assert int(az2.buffer.num_games) > 0
print("SCS_TRAIN_WORKER_OK", jax.process_index(), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_scs_training(tmp_path):
    """The flagship SCS stack end-to-end across 2 host processes —
    closes the round-4 'SCS has never executed on more than one device'
    gap as far as this environment allows (BASELINE config 5 simulated)."""
    coord = f"127.0.0.1:{_free_port()}"
    run_dir = str(tmp_path / "mp_scs")
    os.makedirs(run_dir)
    script = tmp_path / "worker.py"
    script.write_text(
        SCS_TRAIN_WORKER
        % {"repo": REPO, "coord": coord, "run_dir": run_dir}
    )
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(rank)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    for out in outs:
        assert "SCS_TRAIN_WORKER_OK" in out
    sums = [
        float(line.split()[1])
        for out in outs
        for line in out.splitlines()
        if line.startswith("PARAM_SUM")
    ]
    assert len(sums) == 2 and sums[0] == sums[1], sums

    lines = [
        json.loads(l) for l in open(os.path.join(run_dir, "journal.jsonl"))
    ]
    steps = [l["step"] for l in lines if "loss/combined" in l]
    assert steps == [1, 2], steps
