"""CLI entry point (ref ``Run.py``).

    python run.py --training-preset N [--name NAME]
    python run.py --testing-preset N
    python run.py --debug N
    python run.py --interactive

Training presets (ref ``Run.py:92-190``; presets re-based on the shipped
configs under ``configs/``):
  0: Tic-Tac-Toe + MLP (ref preset 0)
  1: Tic-Tac-Toe + RecurrentNet
  2: SCS 5x5 randomized + hex RecurrentNet (ref working preset 2)
  3: SCS solo-scout + hex RecurrentNet (extrapolation training)

Testing presets (ref ``Run.py:201-233``):
  0: TTT — trained policy & mcts agents vs random (needs preset-0 run)
  1: SCS — goal-rush vs random baseline match
  2: SCS — recurrent-iteration extrapolation sweep on a trained net
  3: SCS — board-size transfer sweep (5x5-trained net on 5..15 boards,
     ref Plots/sizes experiments)

Debug presets (ref ``Run.py:328-345``):
  0: TTT random playout smoke
  1: SCS env random playout + ASCII render
  2: MCTS tree dump on the TTT opening (ref Explorer.print_tree)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.abspath(__file__))
# Persistent XLA compile cache, kept where JAX_COMPILATION_CACHE_DIR says
# (default: .jax_cache in the repo); the first compile of the self-play
# program can take minutes, identical re-runs hit the cache.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache")
)
RUNS = os.path.join(REPO, "runs")


def _ttt_env():
    from nuzero.envs import TicTacToe

    return TicTacToe()


def _scs_env(scenario_file: str, seed: int = 42, randomize_vp: bool = False):
    from nuzero.envs.scs import SCSGame, load_scenario

    scenario = load_scenario(
        os.path.join(REPO, "configs", "scenarios", scenario_file), seed=seed
    )
    return SCSGame(scenario, randomize_vp=randomize_vp)


#: network-scale CLI options, set from main()'s --filters/--net-dtype and
#: threaded through every preset.
_NET_OPTS: dict = {}


def _managers(env, arch: str, hex: bool = True, filters: int = None,
              net_dtype: str = None):
    """``filters``/``net_dtype`` default from --filters/--net-dtype (the
    reference's flagship presets run 256-filter trunks, ref Run.py:148;
    bfloat16 runs the trunk's convs on bf16 operands with f32 master
    params)."""
    import jax.numpy as jnp

    from nuzero.networks import (
        ConvNet,
        MLPNetwork,
        NetworkManager,
        RecurrentNet,
        ResNet,
    )

    filters = filters or _NET_OPTS.get("filters") or 64
    dtype = jnp.dtype(net_dtype or _NET_OPTS.get("dtype") or "float32")

    if arch == "mlp":
        net = MLPNetwork(out_features=env.num_actions)
    elif arch == "conv":
        net = ConvNet(
            policy_channels=env.action_space_shape[0],
            num_filters=filters,
            num_layers=2,
            hex=hex,
            dtype=dtype,
        )
    elif arch == "recurrent":
        net = RecurrentNet(
            policy_channels=env.action_space_shape[0],
            num_filters=filters,
            num_blocks=2,
            hex=hex,
            dtype=dtype,
        )
    elif arch == "resnet":
        net = ResNet(
            policy_channels=env.action_space_shape[0],
            num_filters=filters,
            num_blocks=4,
            hex=hex,
            dtype=dtype,
        )
    else:
        raise SystemExit(f"unknown architecture {arch!r}")
    return NetworkManager(net, env.observation_shape)


def _maybe_init_distributed():
    """Wire JAX multi-controller when launched multi-host (slurm/launch.py
    exports JAX_COORDINATOR; plain SLURM multi-task runs are recognized
    too).  Must run before any other JAX call on every host."""
    import os

    if os.environ.get("JAX_COORDINATOR") or (
        int(os.environ.get("SLURM_NTASKS", "1") or 1) > 1
    ):
        from nuzero.parallel.distributed import initialize_distributed

        initialize_distributed()
        import jax

        print(
            f"jax.distributed: process {jax.process_index()}/"
            f"{jax.process_count()}, {len(jax.devices())} global devices"
        )


def _train(env, manager, train_cfg_file, search_cfg_file, name=None,
           state_set=None, meta=None):
    import jax

    from nuzero.config import load_search_config, load_training_config
    from nuzero.parallel import make_mesh
    from nuzero.training import AlphaZero

    cfg = load_training_config(os.path.join(REPO, "configs", "training", train_cfg_file))
    search = load_search_config(os.path.join(REPO, "configs", "search", search_cfg_file))
    # Multi-device: shard self-play + replay over a dp mesh automatically
    # (the reference's Ray-cluster topology, as one SPMD program).
    devices = jax.devices()
    mesh = make_mesh(devices) if len(devices) > 1 else None
    if mesh is not None:
        print(f"training on a {mesh.size}-device dp mesh")
    run_name = name or cfg.network_name
    run_dir = os.path.join(RUNS, run_name)
    os.makedirs(run_dir, exist_ok=True)
    # Back up configs beside checkpoints (ref AlphaZero.py:184-187).
    # Process 0 only: in multi-controller runs every host executes this
    # function against the same shared run_dir.
    if jax.process_index() == 0:
        import shutil

        shutil.copy(
            os.path.join(REPO, "configs", "training", train_cfg_file),
            os.path.join(run_dir, "train_config_copy.yaml"),
        )
        shutil.copy(
            os.path.join(REPO, "configs", "search", search_cfg_file),
            os.path.join(run_dir, "search_config_copy.yaml"),
        )
        if meta:
            # Enough to rebuild env+network on resume (wizard continue).
            from nuzero.config.run_meta import save_run_meta

            save_run_meta(run_dir, **meta)
    az = AlphaZero(
        env, manager, cfg, search, run_dir=run_dir, state_set=state_set,
        mesh=mesh,
    )
    if cfg.load_checkpoint:
        state, step = az.load(cfg.checkpoint.iteration_number)
        az.run(initial_state=state, starting_step=step)
    else:
        az.run()
    print(f"run complete; artifacts in {run_dir}")


def training_preset(idx: int, name, train_cfg=None, search_cfg=None):
    """``train_cfg``/``search_cfg`` override the preset's config files
    (--train-config/--search-config; the reference hard-wires preset
    configs, ref Run.py:92-190 — the override keeps one preset per
    game/model family instead of one per experiment)."""
    if idx == 0:
        env = _ttt_env()
        _train(
            env, _managers(env, "mlp"),
            train_cfg or "ttt_default.yaml", search_cfg or "ttt_search.yaml",
            name, meta=dict(game="ttt", arch="mlp", hex=False),
        )
    elif idx == 1:
        env = _ttt_env()
        _train(
            env,
            _managers(env, "recurrent", hex=False),
            train_cfg or "ttt_default.yaml",
            search_cfg or "ttt_search.yaml",
            name or "ttt_recurrent",
            meta=dict(game="ttt", arch="recurrent", hex=False,
                      num_filters=_NET_OPTS.get("filters", 64)),
        )
    elif idx == 2:
        from nuzero.evaluation import mirrored_state_set

        env = _scs_env("open_field_5.yml")
        # Value-probe state set as in the working reference preset
        # (ref Run.py:144: create_mirrored_state_set).
        _train(
            env,
            _managers(env, "recurrent"),
            train_cfg or "scs_small.yaml",
            search_cfg or "scs_search.yaml",
            name,
            state_set=mirrored_state_set(env),
            meta=dict(game="scs", arch="recurrent",
                      scenario="open_field_5.yml",
                      num_filters=_NET_OPTS.get("filters", 64)),
        )
    elif idx == 3:
        from nuzero.evaluation import solo_state_set

        # Per-game VP randomization = the reference's training
        # distribution (each self-play game reloads the Randomized
        # scenario, ref Training/Gamer.py fresh game per play_game);
        # without it the scout memorizes one route and transfers to
        # nothing (see SCSGame.randomize_vp docstring).
        env = _scs_env("solo_scout_5.yml", randomize_vp=True)
        _train(
            env,
            _managers(env, "recurrent"),
            train_cfg or "scs_small.yaml",
            search_cfg or "scs_search.yaml",
            name or "scs_solo_net",
            state_set=solo_state_set(env),
            meta=dict(game="scs", arch="recurrent",
                      scenario="solo_scout_5.yml", randomize_vp=True,
                      num_filters=_NET_OPTS.get("filters", 64)),
        )
    else:
        raise SystemExit(f"unknown training preset {idx}")


def testing_preset(idx: int, name):
    import jax

    from nuzero.evaluation import (
        GoalRushAgent,
        MctsAgent,
        PolicyAgent,
        RandomAgent,
        TestManager,
    )
    from nuzero.search import SearchParams
    from nuzero.utils.checkpoint import restore_checkpoint

    if idx == 0:
        env = _ttt_env()
        manager = _managers(env, "mlp")
        run_dir = os.path.join(RUNS, name or "ttt_net")
        tree, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto")
        params = tree["params"]
        tm = TestManager(env)
        print(f"evaluating checkpoint step {step} from {run_dir}")
        tm.run_test_batch(256, PolicyAgent(manager, params), RandomAgent())
        tm.run_test_batch(256, RandomAgent(), PolicyAgent(manager, params))
        agent = MctsAgent(manager, params, SearchParams(num_simulations=100))
        tm.run_test_batch(128, agent, RandomAgent())
        tm.run_test_batch(128, RandomAgent(), agent)
    elif idx == 1:
        env = _scs_env("solo_scout_5.yml")
        tm = TestManager(env)
        tm.run_test_batch(64, RandomAgent(), GoalRushAgent())
        tm.run_test_batch(64, RandomAgent(), RandomAgent())
    elif idx == 2:
        env = _scs_env("solo_scout_5.yml")
        manager = _managers(env, "recurrent")
        run_name = name or "scs_solo_net"
        run_dir = os.path.join(RUNS, run_name)
        _, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto")
        tm = TestManager(env)
        # The trained net plays PLAYER 1 (the reference's "p2"): in the
        # solo-scout scenario only p2 owns a unit, so the sweep measures
        # the scout's goal-reaching rate vs test-time iterations.
        cfg = {
            "Test": {
                "test_type": "data",
                "Data": {
                    "Variable": {
                        "changing_agent": 2,
                        "changing_parameter": {
                            "name": "iterations",
                            "Range": {"first": 2, "last": 20, "step": 2},
                        },
                    },
                    "Runs": {"num_runs": 1, "num_games_per_run": 64},
                },
            },
            "Agents": {
                "p1_agent": {"agent_type": "random"},
                "p2_agent": {
                    "agent_type": "policy",
                    "Network": {
                        "recurrent_iterations": 2,
                        # Load the run's latest checkpoint through the
                        # normal Testing-YAML mechanism (the agents are
                        # built INSIDE test_from_config).
                        "load_checkpoint": True,
                        "Checkpoint": {
                            "cp_network_name": run_name,
                            "cp_number": "auto",
                        },
                    },
                },
            },
        }
        results = tm.test_from_config(cfg, manager=manager, game_dir=RUNS)
        print(results)
        # Save the extrapolation curve (data + plot) beside the run's
        # other plots (ref Plots/PlotMaker.py iteration curves + the
        # pickled _graph_data the reference keeps for replotting).
        import json

        os.makedirs(os.path.join(run_dir, "plots"), exist_ok=True)
        with open(
            os.path.join(run_dir, "plots", "iteration_sweep.json"), "w"
        ) as f:
            json.dump(
                {
                    "checkpoint_step": step,
                    "results": [
                        {"iterations": v, "p0_wr": wr[0], "p1_wr": wr[1],
                         "draw_rate": wr[2]}
                        for v, wr in results
                    ],
                },
                f,
                indent=1,
            )
        from nuzero.utils.plots import plot_iteration_sweep

        out = plot_iteration_sweep(
            results,
            os.path.join(run_dir, "plots", "iteration_sweep.png"),
            title=f"{name or 'scs_solo_net'} step {step}: win rate vs "
            "recurrent iterations",
            seat=1,
        )
        if out:
            print(f"sweep plot written to {out}")
    elif idx == 3:
        # Board-size transfer (ref Plots/sizes experiments,
        # Plots/PlotMaker.py:20-35): the solo-scout net trained on 5x5 is
        # evaluated UNCHANGED on progressively larger boards (the
        # fully-convolutional net re-jits per shape; the turn limit scales
        # with board size so every size stays winnable), at several
        # test-time recurrent-iteration counts — the DeepThinking claim
        # that extra thinking extrapolates strategies to bigger maps.
        import json
        import math

        from nuzero.envs.scs import SCSGame, load_scenario

        run_name = name or "scs_solo_rvp_r4"
        run_dir = os.path.join(RUNS, run_name)
        _, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto")
        base_size, base_turns = 5, 7
        scenario_path = os.path.join(
            REPO, "configs", "scenarios", "solo_scout_5.yml"
        )

        def env_factory(size):
            return SCSGame(load_scenario(
                scenario_path,
                seed=42,
                board_size=size,
                turns=math.ceil(base_turns * size / base_size),
            ), randomize_vp=True)

        env5 = env_factory(base_size)
        manager = _managers(env5, "recurrent")
        sizes = dict(first=5, last=15, step=2)
        curves = {}
        for iters in (2, 6, 24):
            tm = TestManager(env5, 64)
            cfg = {
                "Test": {
                    "test_type": "data",
                    "Data": {
                        "Variable": {
                            "changing_agent": 2,
                            "changing_parameter": {
                                "name": "board_size", "Range": sizes,
                            },
                        },
                        "Runs": {"num_runs": 1, "num_games_per_run": 64},
                    },
                },
                "Agents": {
                    "p1_agent": {"agent_type": "random"},
                    "p2_agent": {
                        "agent_type": "policy",
                        "Network": {
                            "recurrent_iterations": iters,
                            "load_checkpoint": True,
                            "Checkpoint": {
                                "cp_network_name": run_name,
                                "cp_number": "auto",
                            },
                        },
                    },
                },
            }
            print(f"--- size sweep at {iters} recurrent iterations")
            curves[f"{iters} iterations"] = tm.test_from_config(
                cfg, manager=manager, game_dir=RUNS, env_factory=env_factory
            )
        os.makedirs(os.path.join(run_dir, "plots"), exist_ok=True)
        with open(
            os.path.join(run_dir, "plots", "size_sweep.json"), "w"
        ) as f:
            json.dump(
                {
                    "checkpoint_step": step,
                    "train_size": base_size,
                    "turn_rule": "ceil(7 * size / 5)",
                    "curves": {
                        label: [
                            {"board_size": v, "p0_wr": wr[0],
                             "p1_wr": wr[1], "draw_rate": wr[2]}
                            for v, wr in results
                        ]
                        for label, results in curves.items()
                    },
                },
                f,
                indent=1,
            )
        from nuzero.utils.plots import plot_size_sweep

        out = plot_size_sweep(
            curves,
            os.path.join(run_dir, "plots", "size_sweep.png"),
            title=f"{run_name} step {step}: 5x5-trained scout vs board size",
            seat=1,
            train_size=base_size,
        )
        if out:
            print(f"size-sweep plot written to {out}")
    else:
        raise SystemExit(f"unknown testing preset {idx}")


def analyse_run(name: str, max_moves: int = 400, auto: bool = False,
                fps: int = 30):
    """--analyse: play one fresh game with the run's latest network (both
    seats) and step through it in the SCS viewer (ref
    ``SCS_Renderer.analyse``, ``SCS_Renderer.py:105-219``, driven from
    Tester — ``Tester.py:27-35``).  The action history is saved beside the
    checkpoints for later replays."""
    import json

    import jax

    from nuzero.config.run_meta import build_from_meta, load_run_meta
    from nuzero.evaluation import PolicyAgent
    from nuzero.utils.checkpoint import restore_checkpoint
    from nuzero.utils.viewer import SCSViewer

    run_dir = os.path.join(RUNS, name)
    meta = load_run_meta(run_dir)
    if meta is None:
        raise SystemExit(
            f"{run_dir} has no run_meta.yaml; re-launch the run once via "
            "run.py to write one"
        )
    if meta.get("game") != "scs":
        raise SystemExit("--analyse renders SCS runs only")
    env, manager = build_from_meta(meta, REPO)
    tree, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto")
    params = tree["params"]
    agent = PolicyAgent(manager, params)
    print(f"playing one game with checkpoint step {step} ...")
    state = env.init(None)
    actions = []
    rng = jax.random.key(0)
    while not bool(env.terminal(state)) and len(actions) < max_moves:
        rng, k = jax.random.split(rng)
        a = agent.choose_host(env, state, params, k, len(actions))
        state = env.step(state, jax.numpy.int32(a))
        actions.append(int(a))
    path = os.path.join(run_dir, "analysis_actions.json")
    with open(path, "w") as f:
        json.dump(actions, f)
    print(f"{len(actions)} moves (terminal={bool(env.terminal(state))}); "
          f"history saved to {path}")
    SCSViewer(env).analyse(actions, fps=fps, auto=auto)
    return actions


def live_goalrush(max_moves: int = 400, fps: int = 8):
    """--testing-preset 1 --view: watch the goal-rush baseline game live
    (ref RemoteTester + SCS_Renderer.render polling loop,
    ``SCS_Renderer.py:51-102``)."""
    import jax

    from nuzero.evaluation import GoalRushAgent, RandomAgent
    from nuzero.utils.viewer import SCSViewer

    env = _scs_env("solo_scout_5.yml")
    agents = {0: GoalRushAgent(), 1: RandomAgent()}
    holder = {"state": env.init(None), "moves": 0}

    def poll():
        s = holder["state"]
        if bool(env.terminal(s)) or holder["moves"] >= max_moves:
            return s
        p = int(env.current_player(s))
        rng = jax.random.key(holder["moves"])
        a = agents[p].choose_host(env, s, None, rng, holder["moves"])
        holder["state"] = env.step(s, jax.numpy.int32(a))
        holder["moves"] += 1
        return holder["state"]

    SCSViewer(env).live(poll, fps=fps)


def debug_preset(idx: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    if idx == 0:
        env = _ttt_env()
        s = env.init(None)
        rng = np.random.default_rng(0)
        while not bool(env.terminal(s)):
            legal = np.flatnonzero(np.asarray(env.legal_mask(s)))
            s = env.step(s, jnp.int32(int(rng.choice(legal))))
        print(env.render(s))
        print("terminal value:", float(s.terminal_value))
    elif idx == 1:
        env = _scs_env("open_field_5.yml")
        from nuzero.utils.render import render_scs_ascii

        s = env.init(None)
        rng = np.random.default_rng(0)
        moves = 0
        while not bool(env.terminal(s)) and moves < 1000:
            legal = np.flatnonzero(np.asarray(env.legal_mask(s)))
            s = env.step(s, jnp.int32(int(rng.choice(legal))))
            moves += 1
        print(render_scs_ascii(env, s))
        print("moves:", moves, "terminal value:", float(s.terminal_value))
    elif idx == 2:
        # MCTS tree dump: search the opening TTT position and print the
        # array tree (ref Explorer.print_tree, Search/Explorer.py:216).
        from nuzero.search import SearchParams
        from nuzero.search.mcts import make_search_fn
        from nuzero.search.tree import print_tree

        env = _ttt_env()
        manager = _managers(env, "mlp", hex=False)
        variables = manager.init(jax.random.key(0))

        def net(v, obs):
            p, val, _ = manager.apply(v, obs)
            return p, val

        params = SearchParams(num_simulations=64, keep_subtree=True)
        search = jax.jit(
            make_search_fn(env, net, params, training=False, with_tree=True)
        )
        states = jax.tree.map(
            lambda x: jnp.stack([x]), env.init(jax.random.key(1))
        )
        res, tree = search(
            variables, states, jnp.zeros(1, jnp.int32), jax.random.key(2),
            None, None,
        )
        print_tree(tree, game_idx=0)
        print(f"chosen action: {int(res.action[0])}, "
              f"root value {float(res.root_value[0]):+.3f}")
    else:
        raise SystemExit(f"unknown debug preset {idx}")


def main():
    parser = argparse.ArgumentParser(description="NuZero runner")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--training-preset", type=int)
    group.add_argument("--testing-preset", type=int)
    group.add_argument("--debug", type=int)
    group.add_argument("--interactive", action="store_true")
    group.add_argument(
        "--play",
        choices=["random", "mcts"],
        help="play Tic-Tac-Toe in the terminal against an agent "
        "(ref Tester.ttt_vs_agent)",
    )
    group.add_argument(
        "--analyse",
        type=str,
        metavar="RUN",
        help="replay a game played by RUN's latest checkpoint in the SCS "
        "viewer (ref SCS_Renderer.analyse)",
    )
    parser.add_argument(
        "--view",
        action="store_true",
        help="with --testing-preset 1: watch the goal-rush game live "
        "(ref SCS_RemoteRenderer)",
    )
    parser.add_argument("--name", type=str, default=None,
                        help="run/network name override")
    parser.add_argument(
        "--train-config", type=str, default=None,
        help="training-config filename under configs/training/ "
        "(overrides the preset's default)",
    )
    parser.add_argument(
        "--search-config", type=str, default=None,
        help="search-config filename under configs/search/ "
        "(overrides the preset's default)",
    )
    parser.add_argument(
        "--filters", type=int, default=None,
        help="trunk filter count for conv/recurrent/resnet presets "
        "(default 64; the reference's flagship presets use 256)",
    )
    parser.add_argument(
        "--net-dtype", type=str, default=None,
        choices=["float32", "bfloat16"],
        help="network COMPUTE dtype (params stay float32)",
    )
    parser.add_argument(
        "--cache",
        choices=["dict", "keyless", "disabled"],
        default="disabled",
        help="host inference cache for --play agents "
        "(ref Cache config section)",
    )
    args = parser.parse_args()
    if args.filters:
        _NET_OPTS["filters"] = args.filters
    if args.net_dtype:
        _NET_OPTS["dtype"] = args.net_dtype

    if args.training_preset is not None:
        # Before ANY jax call (backend init) on every host.
        _maybe_init_distributed()
        training_preset(
            args.training_preset, args.name,
            train_cfg=args.train_config, search_cfg=args.search_config,
        )
    elif args.testing_preset is not None:
        if args.view and args.testing_preset == 1:
            live_goalrush()
        testing_preset(args.testing_preset, args.name)
    elif args.analyse is not None:
        analyse_run(args.analyse)
    elif args.debug is not None:
        debug_preset(args.debug)
    elif args.play is not None:
        from nuzero.evaluation import MctsAgent, RandomAgent, play_vs_agent

        env = _ttt_env()
        if args.play == "mcts":
            import jax

            from nuzero.search import SearchParams

            manager = _managers(env, "mlp", hex=False)
            variables = manager.init(jax.random.key(0))
            agent = MctsAgent(
                manager, variables, SearchParams(num_simulations=100)
            )
        else:
            agent = RandomAgent()
        if args.cache != "disabled":
            from nuzero.utils.caches import create_cache

            agent.set_cache(create_cache(args.cache, 4096))
        play_vs_agent(env, agent, human_player=0)
    elif args.interactive:
        from nuzero.interactive import start

        start()


if __name__ == "__main__":
    main()
