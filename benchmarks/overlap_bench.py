"""Measure what true self-play/SGD overlap could buy on one chip.

The reference's asynchronous mode overlaps self-play and learning in
separate PROCESSES (Gamers play_forever while the learner trains on a
timer, ref ``Training/AlphaZero.py:389-404``).  This framework's async
mode is phase-alternating on ONE device.  One process's XLA programs
run one at a time on its device (one stream), so "true" overlap cannot
reclaim device time — it can only hide HOST latency (keeping the device queue fed).
This harness quantifies exactly that:

1. ``loop_rate``: MCTS-backed env-steps/s of the self-play phase inside
   the REAL training loop (async mode, pipelined dispatch), vs
2. ``pure_rate``: the same self-play program in a bench-style pure device
   loop (no training, no journal) — the bench.py methodology, and
3. ``train_frac``: the fraction of each training step the device spends
   in SGD + sampling.

If ``loop_rate / pure_rate`` is ~1, the phase barriers and host work are
already hidden and process-style overlap has nothing left to reclaim;
``train_frac`` bounds what hiding the LEARNER behind self-play could save
— but on one chip the SGD program still consumes device time, so that
bound is reachable only with a second chip (where the dp mesh already
shards the work instead).

Run:  python benchmarks/overlap_bench.py        (one JSON line)
Knobs: OVB_STEPS, OVB_ACTORS, OVB_SIMS, OVB_DELAY.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    ),
)

import jax


def main():
    import tempfile

    from nuzero.config.schemas import (
        LearningConfig,
        RunningConfig,
        SavingConfig,
        TestingFrequencyConfig,
        TrainingConfig,
    )
    from nuzero.envs import TicTacToe
    from nuzero.networks import MLPNetwork, NetworkManager
    from nuzero.search import SearchParams
    from nuzero.training import AlphaZero

    steps = int(os.environ.get("OVB_STEPS", 30))
    actors = int(os.environ.get("OVB_ACTORS", 1024))
    sims = int(os.environ.get("OVB_SIMS", 100))
    delay = float(os.environ.get("OVB_DELAY", 0.25))

    env = TicTacToe()
    mgr = NetworkManager(MLPNetwork(out_features=9), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(
            running_mode="asynchronous",
            num_actors=actors,
            training_steps=steps,
            update_delay=delay,
            early_fill_per_type=actors // 4,
        ),
        learning=LearningConfig(
            replay_window_size=4096, batch_size=1024, num_samples=4
        ),
        testing=TestingFrequencyConfig(
            policy_test_frequency=0, mcts_test_frequency=0
        ),
        saving=SavingConfig(save_frequency=10 ** 9),
    )
    run_dir = tempfile.mkdtemp(prefix="overlap_bench_")
    az = AlphaZero(
        env, mgr, cfg, SearchParams(num_simulations=sims), run_dir=run_dir
    )
    t0 = time.time()
    az.run(seed=0)
    wall = time.time() - t0

    recs = az.journal.load()
    recs = [r for r in recs if "selfplay/env_steps_per_s" in r]
    tail = recs[len(recs) // 3:]  # steady state
    loop_rate = sum(r["selfplay/env_steps_per_s"] for r in tail) / len(tail)
    sp_t = sum(r["time/selfplay"] for r in tail)
    tr_t = sum(r["time/train"] for r in tail)
    step_t = sum(r["step_time_s"] for r in tail)

    # Pure device loop at the same config (bench.py methodology).
    from nuzero.training.selfplay import init_selfplay, make_selfplay_step

    params = SearchParams(num_simulations=sims)

    def net(v, obs):
        p, val, _ = mgr.apply(v, obs)
        return p, val

    step_fn = jax.jit(make_selfplay_step(env, net, params), donate_argnums=(1,))
    variables = mgr.init(jax.random.key(0))
    sp = init_selfplay(env, actors, jax.random.key(1), search_params=params)
    for _ in range(2):
        sp, _, _ = step_fn(variables, sp)
    sp = jax.block_until_ready(sp)
    reps = 12
    t0 = time.perf_counter()
    for _ in range(reps):
        sp, _, _ = step_fn(variables, sp)
    sp = jax.block_until_ready(sp)
    pure_rate = actors * sims / ((time.perf_counter() - t0) / reps)

    print(json.dumps({
        "metric": "async_overlap_analysis",
        "loop_env_steps_per_s": round(loop_rate),
        "pure_env_steps_per_s": round(pure_rate),
        "loop_over_pure": round(loop_rate / pure_rate, 3),
        "train_frac_of_step": round(tr_t / step_t, 3),
        "selfplay_frac_of_step": round(sp_t / step_t, 3),
        "steps": steps,
        "actors": actors,
        "sims": sims,
        "update_delay_s": delay,
        "wall_s": round(wall, 1),
    }))


if __name__ == "__main__":
    main()
