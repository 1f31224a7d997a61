"""Search-budget scaling probe: SCS self-play at the reference's
simulation budgets.

Shipped reference configs run 300-800 MCTS simulations per move
(ref ``Configs/Search/Examples/documentation_search_config.yaml:3``,
SURVEY §3.4); the standing bench legs run 30.  This probe measures
MCTS-backed env-steps/s (= sims/s) at 30/100/300/800 simulations on the
SCS 5x5 workload so the cost model in ``SearchParams``'s docstring —
per-simulation work growing with tree capacity — is measured, not
predicted, and regressions in the large-budget path are visible.

"Linear scaling in sims" == flat env-steps/s across rows (each
simulation advances one scratch env state, so the rate already divides
by the budget).

Usage:
    python benchmarks/sims_scaling_bench.py            # 64f f32
    SIMS_FILTERS=256 SIMS_DTYPE=bfloat16 python benchmarks/sims_scaling_bench.py
    SIMS_LIST=30,300 SIMS_BATCH=256 ...                # subset / smaller B

Memory note: at 800 sims the carried trees are [B, 1604, A]-shaped; check
``memory_analysis()`` before running B=512 (SIMS_BATCH lowers it).

Prints one JSON line per budget: rate, per-sim ms, tree capacity.
"""

import json
import os
import statistics
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
import jax.numpy as jnp


def main():
    from nuzero.envs.scs import SCSGame, load_scenario
    from nuzero.networks import NetworkManager, RecurrentNet
    from nuzero.search import SearchParams
    from nuzero.training.selfplay import init_selfplay, make_selfplay_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sims_list = [
        int(s)
        for s in os.environ.get("SIMS_LIST", "30,100,300,800").split(",")
    ]
    batch = int(os.environ.get("SIMS_BATCH", 512))
    filters = int(os.environ.get("SIMS_FILTERS", 64))
    dtype = os.environ.get("SIMS_DTYPE", "float32")
    reps = int(os.environ.get("SIMS_REPS", 3))
    trials = int(os.environ.get("SIMS_TRIALS", 3))

    scenario = load_scenario(
        os.path.join(repo, "configs", "scenarios", "open_field_5.yml"),
        seed=42,
    )
    env = SCSGame(scenario)
    net_mod = RecurrentNet(
        policy_channels=env.action_space_shape[0],
        num_filters=filters,
        num_blocks=2,
        hex=True,
        dtype=jnp.dtype(dtype),
    )
    mgr = NetworkManager(net_mod, env.observation_shape)
    variables = mgr.init(jax.random.key(0))

    def net(v, obs):
        p, val, _ = mgr.apply(v, obs, iters_to_do=2)
        return p, val

    results = []
    for sims in sims_list:
        params = SearchParams(num_simulations=sims)
        step = jax.jit(
            make_selfplay_step(env, net, params), donate_argnums=(1,)
        )
        sp = init_selfplay(
            env, batch, jax.random.key(1), search_params=params
        )
        for _ in range(2):
            sp, _, _ = step(variables, sp)
        sp = jax.block_until_ready(sp)
        rates = []
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(reps):
                sp, _, _ = step(variables, sp)
            sp = jax.block_until_ready(sp)
            dt = (time.perf_counter() - t0) / reps
            rates.append(batch * sims / dt)
        cap = params.tree_capacity or (2 * sims + 4)
        row = {
            "sims": sims,
            "env_steps_per_s": round(statistics.median(rates), 1),
            "ms_per_move_batch": round(
                batch * sims / statistics.median(rates) * 1e3, 2
            ),
            "tree_capacity": cap,
            "batch": batch,
            "filters": filters,
            "dtype": dtype,
            "trials": [round(r, 1) for r in rates],
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    # Scaling verdict: worst-case rate degradation across budgets.
    base = results[0]["env_steps_per_s"]
    worst = min(r["env_steps_per_s"] for r in results)
    print(
        json.dumps(
            {
                "scaling_verdict": {
                    "baseline_sims": results[0]["sims"],
                    "min_rate_ratio_vs_baseline": round(worst / base, 3),
                }
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
