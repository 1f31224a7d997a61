"""Agent zoo for evaluation (ref ``Testing/Agents/``).

Each agent exposes ``policy(env) -> fn(states, lengths, rng) -> actions``:
a *batched* action chooser over B concurrent games, jit-composable into the
arena loop.  The reference's per-game Python agents
(``Agent.choose_action(game)``) become vectorized policies:

- ``RandomAgent``: uniform over the legal mask
  (ref ``Agents/Generic/RandomAgent.py:11-16``).
- ``PolicyAgent``: raw-network argmax with the reference's fallback chain —
  argmax; if illegal, mask+renormalize and argmax; if the net puts zero
  mass on legal actions, uniform-random legal
  (ref ``Agents/Generic/PolicyAgent.py:19-64``).
- ``MctsAgent``: full eval-mode (argmax-visits, no noise) batched MCTS per
  move (ref ``Agents/Generic/MctsAgent.py:28-39``).
- ``GoalRushAgent``: scripted SCS baseline rushing the nearest enemy
  victory point along a host-precomputed Dijkstra distance field
  (ref ``Agents/SCS/GoalRushAgent.py`` — the reference implementation is
  stale vs the current SCS API (SURVEY §2.6 known bitrot); this is a
  working re-design with the same intent).
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nuzero.search.mcts import SearchParams, make_search_fn

NEG_INF = jnp.float32(-1e9)


class Agent:
    name: str = "agent"
    # Optional host inference cache for host-driven (batch-1) play — human
    # games and visual tests (ref per-agent Cache section in the Testing
    # YAML, ``TestManager.py:282-295``).  The batched device path never
    # consults it: leaf evaluations are already fused into large batched
    # calls, which is what the reference's caches tried to approximate.
    cache = None

    def set_cache(self, cache) -> None:
        self.cache = cache

    def choose_host(self, env, state, variables, rng, move_count: int = 0) -> int:
        """Pick one action for a single host-side state, memoized through
        ``self.cache`` when set.  The reference caches batch-1 NN outputs
        inside Explorer/PolicyAgent (``Explorer.py:137-160``); here the
        deterministic eval-mode agents memoize the chosen action per
        observed state — the same work saved, one level up."""
        import numpy as np

        obs = None
        if self.cache is not None:
            obs = np.asarray(env.observe(state))
            hit = self.cache.get(obs)
            if hit is not None:
                return int(hit)
        pol = self.policy(env)
        batched = jax.tree.map(lambda x: jnp.stack([x]), state)
        lengths = jnp.full((1,), move_count, jnp.int32)
        action = int(np.asarray(pol(variables, batched, lengths, rng))[0])
        if self.cache is not None:
            self.cache.put((obs, action))
        return action

    def policy(self, env) -> Callable:
        """Memoized batched action chooser for ``env``.  The cache key
        includes anything that changes the compiled program (e.g. the
        recurrent iteration count); network parameters are runtime
        arguments, never baked in."""
        cache = self.__dict__.setdefault("_policy_cache", {})
        key = (id(env), self._policy_key())
        if key not in cache:
            cache[key] = self._build_policy(env)
        return cache[key]

    def _policy_key(self):
        return None

    def _build_policy(self, env) -> Callable:
        raise NotImplementedError

    # Sweep support (ref TestManager.test_from_config setters).
    def set_network(self, variables) -> None:
        pass

    def set_recurrent_iterations(self, iters: int) -> None:
        pass


class RandomAgent(Agent):
    name = "random"

    def _build_policy(self, env):
        def choose(variables, states, lengths, rng):
            del variables, lengths
            legal = jax.vmap(env.legal_mask)(states)
            logits = jnp.where(legal, 0.0, NEG_INF)
            return jax.random.categorical(rng, logits, axis=-1).astype(jnp.int32)

        return choose


class PolicyAgent(Agent):
    name = "policy"

    def __init__(self, manager, variables, recurrent_iterations: int = 2):
        self.manager = manager
        self.variables = variables
        self.recurrent_iterations = recurrent_iterations

    def set_network(self, variables):
        self.variables = variables
        self._reset_cache()

    def set_recurrent_iterations(self, iters):
        self.recurrent_iterations = int(iters)
        self._reset_cache()

    def _reset_cache(self):
        # Network/iteration changes invalidate memoized host decisions
        # (ref MctsAgent.py:59-65 setters reset the cache).
        if self.cache is not None:
            self.cache.clear()

    def _policy_key(self):
        return self.recurrent_iterations

    def _build_policy(self, env):
        manager = self.manager
        iters = self.recurrent_iterations

        def choose(variables, states, lengths, rng):
            del lengths
            obs = jax.vmap(env.observe)(states)
            logits, _, _ = manager.apply(variables, obs, iters_to_do=iters)
            legal = jax.vmap(env.legal_mask)(states)
            raw_argmax = jnp.argmax(logits, axis=-1)
            raw_legal = jnp.take_along_axis(
                legal, raw_argmax[:, None], axis=-1
            )[:, 0]
            # Fallback 1: mask + renormalize (softmax over logits), argmax.
            probs = jax.nn.softmax(logits, axis=-1) * legal
            masked_argmax = jnp.argmax(probs, axis=-1)
            has_mass = probs.sum(-1) > 0
            # Fallback 2: uniform over legal.
            uniform = jax.random.categorical(
                rng, jnp.where(legal, 0.0, NEG_INF), axis=-1
            )
            action = jnp.where(
                raw_legal,
                raw_argmax,
                jnp.where(has_mass, masked_argmax, uniform),
            )
            return action.astype(jnp.int32)

        return choose


class MctsAgent(Agent):
    name = "mcts"

    def __init__(
        self,
        manager,
        variables,
        search_params: SearchParams,
        recurrent_iterations: int = 2,
    ):
        self.manager = manager
        self.variables = variables
        self.search_params = search_params
        self.recurrent_iterations = recurrent_iterations

    def set_network(self, variables):
        self.variables = variables
        self._reset_cache()

    def set_recurrent_iterations(self, iters):
        self.recurrent_iterations = int(iters)
        self._reset_cache()

    def _reset_cache(self):
        if self.cache is not None:
            self.cache.clear()

    def _policy_key(self):
        return (self.recurrent_iterations, self.search_params)

    def _build_policy(self, env):
        manager = self.manager
        iters = self.recurrent_iterations

        def net(variables, obs):
            p, v, _ = manager.apply(variables, obs, iters_to_do=iters)
            return p, v

        search = make_search_fn(env, net, self.search_params, training=False)

        def choose(variables, states, lengths, rng):
            return search(variables, states, lengths, rng).action

        return choose


class GoalRushAgent(Agent):
    """SCS-only scripted baseline: rush the nearest enemy VP, attacking
    enemies that stand on the path (ref ``Agents/SCS/GoalRushAgent.py``).

    Per sub-phase (the legal mask restricts actions to one sub-phase, so
    scores never compete across phases):

    - placement: uniform random (ref ``:26-31``);
    - movement: step to the neighbor with the lowest Dijkstra distance to
      the nearest enemy VP; no-move carries a slight malus (ref ``:34-66``);
    - choose target: target an adjacent enemy tile that is a FORWARD step
      for one of this player's moved units (an adjacent moved unit sits at
      a larger distance than the enemy's tile — the vectorized equivalent
      of "the enemy is on the unit's path", ref ``:68-94``); skip combat
      otherwise (ref ``:96-103``);
    - choose attackers: add attackers (uniformly) while any remain; confirm
      only when it is the sole legal action (ref ``:105-117``).
    """

    name = "goal_rush"

    def _build_policy(self, env):
        if getattr(env, "randomize_vp", False):
            raise ValueError(
                "GoalRushAgent precomputes Dijkstra fields from the "
                "scenario's static VP masks; it cannot play envs with "
                "randomize_vp=True (per-game VP draws)"
            )
        dist = jnp.asarray(self._distance_fields(env))  # f32[2, R, C]
        R, C, K = env.R, env.C, env.K

        def choose(variables, states, lengths, rng):
            del variables, lengths

            def one(state, key):
                p = env.current_player(state)
                legal = env.legal_mask(state)
                my_dist = dist[p]  # f32[R, C]

                total_planes = env.action_space_shape[0]
                plane_scores = jnp.full(
                    (total_planes, R, C), 0.0, jnp.float32
                )
                # -- movement: score by destination distance.
                for d in range(6):
                    ddist = my_dist[env.nbr_r[d], env.nbr_c[d]]
                    for s in range(K):
                        plane_scores = plane_scores.at[
                            1 + d * K + s
                        ].set(ddist)
                for s in range(K):
                    plane_scores = plane_scores.at[
                        env.confirm_limit + s
                    ].set(my_dist + 0.5)  # no-move: stay put, slight malus

                # -- choose target: the legal no-fight planes mark this
                # player's moved units, so "enemy on the path" = a legal
                # target cell adjacent to a moved unit strictly farther
                # from the VP than the target cell.
                lp = legal.reshape(total_planes, R, C)
                moved = lp[env.no_move_limit:env.no_fight_limit].any(0)
                forward = jnp.zeros((R, C), bool)
                for d in range(6):
                    m_nbr = moved[env.nbr_r[d], env.nbr_c[d]] & env.nbr_ok[d]
                    d_nbr = my_dist[env.nbr_r[d], env.nbr_c[d]]
                    forward = forward | (m_nbr & (d_nbr > my_dist))
                target_score = jnp.where(forward, my_dist - 0.25, 1e7)
                plane_scores = plane_scores.at[env.movement_limit].set(
                    target_score
                )
                # no-fight: skip combat (wins when no forward enemy exists,
                # because 1e7 > any reachable distance + 0.5).
                for s in range(K):
                    plane_scores = plane_scores.at[env.no_move_limit + s].set(
                        my_dist + 0.5
                    )

                # -- choose attackers: adding an attacker always beats
                # confirming; ties between attackers break randomly.
                for s in range(K):
                    plane_scores = plane_scores.at[env.target_limit + s].set(
                        -10.0
                    )
                plane_scores = plane_scores.at[env.attackers_limit].set(10.0)

                flat_scores = plane_scores.reshape(-1)
                # Prefer LOW score => negate as logit; uniform noise breaks
                # ties (and makes placement uniform-random).
                noise = jax.random.uniform(key, flat_scores.shape) * 0.01
                score = jnp.where(legal, -flat_scores - noise, NEG_INF)
                return jnp.argmax(score).astype(jnp.int32)

            B = jax.tree.leaves(states)[0].shape[0]
            keys = jax.random.split(rng, B)
            return jax.vmap(one)(states, keys)

        return choose

    @staticmethod
    def _distance_fields(env) -> np.ndarray:
        """Host Dijkstra over terrain entry costs to the nearest enemy VP
        (ref ``GoalRushAgent.py:119-158``)."""
        from nuzero.envs.scs.hexgrid import neighbor_tables

        R, C = env.R, env.C
        cost = np.asarray(env.t_cost)
        vp = np.asarray(env.vp)
        dst_r, dst_c, valid = neighbor_tables(R, C)
        out = np.zeros((2, R, C), np.float32)
        for p in (0, 1):
            targets = np.argwhere(vp[1 - p])  # enemy VP locations
            dist = np.full((R, C), np.inf)
            heap = []
            for (r, c) in targets:
                dist[r, c] = 0.0
                heapq.heappush(heap, (0.0, int(r), int(c)))
            while heap:
                d0, r, c = heapq.heappop(heap)
                if d0 > dist[r, c]:
                    continue
                for k in range(6):
                    if not valid[k, r, c]:
                        continue
                    nr, nc = dst_r[k, r, c], dst_c[k, r, c]
                    # moving from neighbor INTO (r, c) costs cost[r, c];
                    # expanding backwards from targets.
                    nd = d0 + cost[r, c]
                    if nd < dist[nr, nc]:
                        dist[nr, nc] = nd
                        heapq.heappush(heap, (nd, int(nr), int(nc)))
            dist[np.isinf(dist)] = 1e6
            out[p] = dist
        return out
