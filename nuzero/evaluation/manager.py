"""Test orchestration (ref ``Testing/TestManager.py``).

- ``run_test_batch``: play a batch of games between two agents and report
  per-seat win rates (ref ``TestManager.py:85-175``; the Ray ActorPool
  becomes the arena's lockstep game batch).
- ``test_from_config``: the reference's "data tests" — sweep a changing
  parameter (network ``checkpoints`` or recurrent ``iterations``) over a
  range with num_runs x num_games each; this is the DeepThinking
  extrapolation-test machinery (ref ``TestManager.py:177-280``).
- ``create_agent_from_config``: build mcts/policy/goal_rush/random agents,
  optionally restoring network checkpoints
  (ref ``TestManager.py:282-325``).
- ``run_visual_test``: play one game and return its action history for
  replay/rendering (ref ``TestManager.py:70-83``).

Accepts the reference's Testing YAML schema
(ref ``Configs/Testing/Examples/documentation_test_config.yaml``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nuzero.config.yaml_io import load_yaml
from nuzero.config.schemas import load_search_config, search_params_from_dict
from nuzero.evaluation.agents import (
    Agent,
    GoalRushAgent,
    MctsAgent,
    PolicyAgent,
    RandomAgent,
)
from nuzero.evaluation.arena import MatchStats, play_matches
from nuzero.search.mcts import SearchParams
from nuzero.utils.checkpoint import restore_checkpoint, latest_step


class TestManager:
    __test__ = False  # not a pytest class

    def __init__(self, env, num_actors: int = 64):
        """``num_actors`` = concurrent games per batch (the reference's
        tester-process count becomes a batch dimension)."""
        self.env = env
        self.num_actors = num_actors
        self._arenas = {}

    # ------------------------------------------------------------------ #

    def _arena(self, p0_policy, p1_policy):
        from nuzero.evaluation.arena import Arena

        key = (p0_policy, p1_policy)
        if key not in self._arenas:
            self._arenas[key] = Arena(self.env, p0_policy, p1_policy)
        return self._arenas[key]

    def run_test_batch(
        self,
        num_games: int,
        p0_agent: Agent,
        p1_agent: Agent,
        rng: Optional[jax.Array] = None,
        show_results: bool = True,
    ) -> MatchStats:
        rng = rng if rng is not None else jax.random.key(0)
        arena = self._arena(
            p0_agent.policy(self.env), p1_agent.policy(self.env)
        )
        stats = arena.play(
            num_games,
            getattr(p0_agent, "variables", None),
            getattr(p1_agent, "variables", None),
            rng,
        )
        if show_results:
            trunc = (
                f" | truncated {stats.truncated}" if stats.truncated else ""
            )
            print(
                f"{p0_agent.name} (P1) vs {p1_agent.name} (P2): "
                f"P1 {stats.p0_win_rate:.1%} | P2 {stats.p1_win_rate:.1%} "
                f"| draws {stats.draw_rate:.1%} "
                f"| avg length {stats.avg_length:.1f}{trunc}"
            )
        return stats

    # ------------------------------------------------------------------ #

    def create_agent_from_config(
        self,
        agent_cfg: Dict,
        manager=None,
        game_dir: Optional[str] = None,
    ) -> Agent:
        agent_type = agent_cfg["agent_type"]

        def with_cache(agent):
            # Per-agent host inference cache (ref Testing YAML Cache
            # section, TestManager.py:282-295).  Serves host-driven play
            # (visual tests / human games); the batched arena path has no
            # batch-1 inference to cache.
            cache_cfg = agent_cfg.get("Cache")
            if cache_cfg and cache_cfg.get("cache_choice", "disabled") != "disabled":
                from nuzero.utils.caches import create_cache

                agent.set_cache(
                    create_cache(
                        cache_cfg["cache_choice"],
                        int(cache_cfg.get("max_size", 10000)),
                    )
                )
            return agent

        if agent_type == "random":
            return with_cache(RandomAgent())
        if agent_type == "goal_rush":
            return with_cache(GoalRushAgent())

        net_cfg = agent_cfg.get("Network", {})
        iters = int(net_cfg.get("recurrent_iterations", 2))
        variables = None
        if net_cfg.get("load_checkpoint", False):
            ck = net_cfg["Checkpoint"]
            root = os.path.join(
                game_dir or ".", ck["cp_network_name"], "checkpoints"
            )
            tree, _ = restore_checkpoint(root, ck.get("cp_number", "auto"))
            variables = tree["params"]
        if manager is None:
            raise ValueError(
                f"{agent_type} agent needs a NetworkManager (model source)"
            )
        if variables is None:
            variables = manager.init(jax.random.key(0))

        if agent_type == "policy":
            return with_cache(PolicyAgent(manager, variables, iters))
        if agent_type == "mcts":
            sp_path = agent_cfg.get("search_config_path")
            params = (
                load_search_config(sp_path) if sp_path else SearchParams()
            )
            return with_cache(MctsAgent(manager, variables, params, iters))
        raise ValueError(f"unknown agent type {agent_type!r}")

    # ------------------------------------------------------------------ #

    def test_from_config(
        self,
        config,
        manager=None,
        game_dir: Optional[str] = None,
        seed: int = 0,
        env_factory=None,
    ):
        """Run the test described by a Testing YAML (path or dict).

        Data tests return a list of
        ``(parameter_value, (p0_wr, p1_wr, draw_rate))`` points.

        Changing parameters: ``iterations`` (recurrent test-time count) and
        ``checkpoints`` sweep the target agent (ref
        ``TestManager.py:206-263``); ``board_size`` — beyond the reference,
        whose size experiments were hand-run per-size YAMLs
        (``Plots/sizes``) — rebuilds the env per value via ``env_factory(
        size) -> env`` and replays BOTH agents on it (the
        fully-convolutional nets re-jit per shape; checkpoint params
        transfer unchanged)."""
        cfg = load_yaml(config) if isinstance(config, str) else config
        test = cfg["Test"]
        agents_cfg = cfg["Agents"]
        p0 = self.create_agent_from_config(
            agents_cfg["p1_agent"], manager, game_dir
        )
        p1 = self.create_agent_from_config(
            agents_cfg["p2_agent"], manager, game_dir
        )

        if test["test_type"] == "visual":
            return self.run_visual_test(p0, p1, seed=seed)

        data = test["Data"]
        changing_agent = int(data["Variable"]["changing_agent"])
        runs = data["Runs"]
        num_runs = int(runs["num_runs"])
        num_games = int(runs["num_games_per_run"])

        sweep_values: List = [None]
        param_name = None
        if changing_agent != 0:
            param = data["Variable"]["changing_parameter"]
            param_name = param["name"]
            r = param["Range"]
            sweep_values = list(
                range(int(r["first"]), int(r["last"]) + 1, int(r["step"]))
            )

        target = {1: p0, 2: p1}.get(changing_agent)
        results = []
        rng = jax.random.key(seed)
        # board_size sweeps rebind self.env per value; restore the
        # manager's construction-time env (and its compiled arenas) on the
        # way out so later run_test_batch calls don't silently run on the
        # last swept size.
        orig_env, orig_arenas = self.env, self._arenas
        try:
            for value in sweep_values:
                if target is not None and param_name == "iterations":
                    target.set_recurrent_iterations(value)
                elif target is not None and param_name == "checkpoints":
                    ck_root = self._checkpoint_root(
                        agents_cfg, changing_agent, game_dir
                    )
                    tree, _ = restore_checkpoint(ck_root, value)
                    target.set_network(tree["params"])
                elif param_name == "board_size":
                    if env_factory is None:
                        raise ValueError(
                            "board_size sweeps need env_factory(size) -> env"
                        )
                    self.env = env_factory(value)
                    # New env: drop compiled arenas; agent policies re-key
                    # on the new env object automatically (Agent.policy
                    # cache).
                    self._arenas = {}

                wins0 = wins1 = draws = total = 0
                for _ in range(num_runs):
                    rng, sub = jax.random.split(rng)
                    stats = self.run_test_batch(
                        num_games, p0, p1, sub, show_results=False
                    )
                    wins0 += stats.p0_wins
                    wins1 += stats.p1_wins
                    draws += stats.draws
                    total += stats.num_games
                point = (
                    value,
                    (wins0 / total, wins1 / total, draws / total),
                )
                results.append(point)
                label = f"{param_name}={value}: " if value is not None else ""
                print(
                    f"{label}P1 {point[1][0]:.1%} | P2 {point[1][1]:.1%} | "
                    f"draws {point[1][2]:.1%}"
                )
        finally:
            self.env, self._arenas = orig_env, orig_arenas
        return results

    def _checkpoint_root(self, agents_cfg, changing_agent, game_dir):
        key = "p1_agent" if changing_agent == 1 else "p2_agent"
        ck = agents_cfg[key]["Network"]["Checkpoint"]
        return os.path.join(
            game_dir or ".", ck["cp_network_name"], "checkpoints"
        )

    # ------------------------------------------------------------------ #

    def run_visual_test(self, p0_agent: Agent, p1_agent: Agent, seed: int = 0):
        """Play ONE game move-by-move, returning the action history
        (ref ``TestManager.run_visual_test`` + ``Tester`` print/replay)."""
        env = self.env
        v0 = getattr(p0_agent, "variables", None)
        v1 = getattr(p1_agent, "variables", None)
        rng = jax.random.key(seed)
        state = env.init(None)
        history = []
        while not bool(env.terminal(state)):
            rng, k = jax.random.split(rng)
            # choose_host consults the agent's inference cache when set
            # (ref Tester's cache-aware agent loop, Tester.py:46-121).
            if int(env.current_player(state)) == 0:
                a = p0_agent.choose_host(env, state, v0, k, len(history))
            else:
                a = p1_agent.choose_host(env, state, v1, k, len(history))
            assert bool(env.legal_mask(state)[a]), "agent chose illegal move"
            history.append(a)
            state = env.step(state, jnp.int32(a))
        return {
            "actions": history,
            "terminal_value": float(env.terminal_value(state)),
            "length": len(history),
        }
