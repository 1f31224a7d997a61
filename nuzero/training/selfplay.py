"""Lockstep batched self-play engine.

Behavioral target: the reference's ``Gamer`` Ray actors — each plays one
game at a time with per-move MCTS, storing (state, policy-target) pairs and
shipping the finished game to the replay buffer
(ref ``Training/Gamer.py:39-97``).

Design: ONE device program steps B games in lockstep.  Every
move runs the fully-batched MCTS (all games' leaf evaluations fused into
single network calls), records the position into per-game trajectory
buffers, steps the envs, and — where games finished — emits them as a
``FinishedGames`` batch and auto-resets those slots with fresh PRNG keys.
The "actor count" knob becomes the batch dimension; process-level Ray
parallelism becomes array parallelism.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from nuzero.utils import struct

from nuzero.search.mcts import SearchParams, make_search_fn
from nuzero.search.tree import init_tree, reroot
from nuzero.training.replay import FinishedGames


@struct.dataclass
class SelfplayState:
    games: Any  # EnvState batch [B]
    state_buf: jax.Array  # f32[B, L, D] PACKED env states per position
    # (utils.packing) — ~11x smaller than observation tensors for SCS;
    # observations are regenerated from the sampled positions at training
    # time (see the replay.py module docstring)
    policy_buf: jax.Array  # f32[B, L, A] search policy targets
    move_count: jax.Array  # i32[B] moves played in current game
    rng: jax.Array
    total_moves: jax.Array  # i32 stats: lockstep move-steps taken
    total_games: jax.Array  # i32 stats: games completed since init
    # Subtree reuse (ref keep_subtree): search trees carried across moves,
    # re-rooted at the played action.  None when reuse is disabled.
    tree: Any = None
    tree_valid: Any = None  # bool[B]


def init_selfplay(
    env,
    batch_size: int,
    rng: jax.Array,
    trajectory_capacity: int = 0,
    search_params: SearchParams | None = None,
    state_dim: int = 0,
) -> SelfplayState:
    """``trajectory_capacity`` bounds stored moves per game (0 = the env's
    hard ``max_game_length``); games that overrun are discarded and reset
    (the bound formula is deliberately loose — a tight capacity saves the
    dominant trajectory-buffer memory).

    Pass ``search_params`` with ``keep_subtree=True`` to allocate the
    carried search trees enabling subtree reuse across moves (ref
    ``Training/Gamer.py:78-79``); without it each move searches a fresh
    tree.

    ``state_dim`` widens the packed-state rows beyond this env's own
    packed width (0 = exactly this env's) so several game types can share
    one replay buffer."""
    from nuzero.utils.packing import make_packer

    rng, sub = jax.random.split(rng)
    games = jax.vmap(env.init)(jax.random.split(sub, batch_size))
    L = trajectory_capacity or env.max_game_length
    _, _, env_dim = make_packer(env.init(jax.random.key(0)))
    D = max(state_dim, env_dim)
    tree = None
    tree_valid = None
    if search_params is not None and search_params.keep_subtree:
        num_nodes = search_params.tree_capacity or (
            2 * search_params.num_simulations + 4
        )
        tree = jax.vmap(lambda _: init_tree(env.num_actions, num_nodes, env_dim))(
            jnp.arange(batch_size)
        )
        tree_valid = jnp.zeros(batch_size, bool)
    return SelfplayState(
        games=games,
        state_buf=jnp.zeros((batch_size, L, D), jnp.float32),
        policy_buf=jnp.zeros((batch_size, L, env.num_actions), jnp.float32),
        move_count=jnp.zeros(batch_size, jnp.int32),
        rng=rng,
        total_moves=jnp.int32(0),
        total_games=jnp.int32(0),
        tree=tree,
        tree_valid=tree_valid,
    )


def make_selfplay_step(
    env,
    apply_fn: Callable,
    search_params: SearchParams,
    training: bool = True,
    game_type: int = 0,
):
    """Build ``step(variables, sp) -> (sp, FinishedGames, stats)``.

    One call = one move in every live game.  Jit at the call site.
    ``game_type`` tags emitted games for multi-game-type runs (ref per-type
    Gamer pools, ``AlphaZero.py:525-577``).
    """
    from nuzero.utils.packing import make_packer

    pack, _, env_dim = make_packer(env.init(jax.random.key(0)))

    search_fresh = make_search_fn(env, apply_fn, search_params, training)
    search_carry = make_search_fn(
        env, apply_fn, search_params, training, with_tree=True
    )

    def step(variables, sp: SelfplayState):
        B = sp.move_count.shape[0]
        reuse = sp.tree is not None
        rng, k_search, k_reset = jax.random.split(sp.rng, 3)

        if reuse:
            res, tree = search_carry(
                variables, sp.games, sp.move_count, k_search,
                sp.tree, sp.tree_valid,
            )
        else:
            res = search_fresh(variables, sp.games, sp.move_count, k_search)
            tree = None

        # Record the pre-move position (packed state, not observation —
        # see SelfplayState.state_buf) + its search policy
        # (ref Gamer.py:65-66,74-77 store_state/store_search_statistics).
        enc = jax.vmap(pack)(sp.games)
        D = sp.state_buf.shape[2]
        if D > env_dim:
            enc = jnp.pad(enc, ((0, 0), (0, D - env_dim)))
        # Masked full-buffer writes, NOT `.at[bidx, move_count].set`: the
        # vmapped per-game scatter can make XLA lay the [B, L, A] buffers
        # out batch-minor and convert around every other consumer.  One
        # elementwise select pass keeps a single layout and streams each
        # buffer exactly once.
        L = sp.state_buf.shape[1]
        at_row = jnp.arange(L)[None, :] == sp.move_count[:, None]  # [B, L]
        state_buf = jnp.where(
            at_row[:, :, None], enc[:, None, :], sp.state_buf
        )
        policy_buf = jnp.where(
            at_row[:, :, None], res.policy_target[:, None, :], sp.policy_buf
        )

        stepped = jax.vmap(env.step)(sp.games, res.action)
        done = jax.vmap(env.terminal)(stepped)
        overflow = (~done) & (sp.move_count + 1 >= L)

        finished = FinishedGames(
            states=state_buf,
            policy=policy_buf,
            final_value=jax.vmap(env.terminal_value)(stepped),
            length=sp.move_count + 1,
            game_type=jnp.full(B, game_type, jnp.int32),
            mask=done,
        )

        # Auto-reset finished games (and discard trajectory-overflow
        # games) with fresh keys.
        recycle = done | overflow
        fresh = jax.vmap(env.init)(jax.random.split(k_reset, B))

        def select(f, s):
            cond = recycle.reshape((B,) + (1,) * (s.ndim - 1))
            return jnp.where(cond, f, s)

        games = jax.tree.map(select, fresh, stepped)
        move_count = jnp.where(recycle, 0, sp.move_count + 1)

        # Re-root the carried trees at the played actions; recycled games
        # and actions without a materialized child restart from a fresh
        # tree next move (ref Gamer.py:78-79 keep_subtree root swap).
        # Documented deviation: the reference expands ALL legal children at
        # expansion, so its keep_subtree always finds the chosen child
        # (possibly zero-visit); here children materialize lazily, so an
        # epsilon-random pick of an unvisited action costs one fresh tree —
        # rare (epsilon ~1e-3) and only an exploration-efficiency nit.
        tree_valid = None
        if reuse:
            tree, ok = jax.vmap(reroot)(tree, res.action)
            tree_valid = ok & ~recycle

        tree_cap = search_params.tree_capacity or (
            2 * search_params.num_simulations + 4
        )
        stats = {
            "finished": done.sum(),
            "root_value_mean": res.root_value.mean(),
            "tree_nodes_mean": res.tree_nodes.mean(),
            # Fraction of games whose node budget bound this move (the
            # search then stops expanding — surfaced so a binding cap is
            # never silent; raise SearchParams.tree_capacity if > 0).
            "tree_full_frac": (res.tree_nodes >= tree_cap).mean(),
            "exploration_bias_mean": res.exploration_bias.mean(),
            "children_per_node_mean": res.children_per_node.mean(),
            # Fraction of descents stopped by MAX_PATH_DEPTH — 0 on every
            # workload observed so far; nonzero means deep lines are losing
            # exploration and the cap should be raised.
            "depth_capped_frac": res.depth_capped.mean(),
        }
        new_sp = SelfplayState(
            games=games,
            state_buf=state_buf,
            policy_buf=policy_buf,
            move_count=move_count,
            rng=rng,
            total_moves=sp.total_moves + B,
            total_games=sp.total_games + done.sum().astype(jnp.int32),
            tree=tree,
            tree_valid=tree_valid,
        )
        return new_sp, finished, stats

    return step
