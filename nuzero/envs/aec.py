"""PettingZoo AEC adapter for the functional envs.

The reference's SCS_Game *is* a ``pettingzoo.AECEnv`` subclass and is
checked with ``pettingzoo.test.api_test`` (ref ``Games/SCS/SCS_Game.py:67``,
``Run.py:328-345``).  Here the engines are pure
functions; this host-side wrapper restores the AEC interface (mutable
cursor over an immutable state) for ecosystem interop — debugging, external
baselines, and the environment-contract test.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

try:
    import gymnasium
    from gymnasium import spaces
    from pettingzoo import AECEnv

    _HAVE_PZ = True
except ImportError:  # pragma: no cover
    AECEnv = object
    _HAVE_PZ = False


class AECAdapter(AECEnv):
    metadata = {"render_modes": ["ansi"], "name": "nuzero_env"}

    def __init__(self, env, render_mode: Optional[str] = None):
        super().__init__()
        if not _HAVE_PZ:
            raise ImportError("pettingzoo/gymnasium not available")
        self.env = env
        self.render_mode = render_mode
        self.possible_agents = [0, 1]
        self._obs_space = spaces.Box(
            low=-1.0,
            high=np.inf,
            shape=tuple(env.observation_shape),
            dtype=np.float32,
        )
        self._act_space = spaces.Discrete(env.num_actions)
        self._state = None
        self._step = jax.jit(env.step)
        self._legal = jax.jit(env.legal_mask)
        self._observe = jax.jit(env.observe)

    # -- spaces -----------------------------------------------------------

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._act_space

    # -- core -------------------------------------------------------------

    def _mask(self):
        return np.asarray(self._legal(self._state)).astype(np.int8)

    def reset(self, seed=None, options=None):
        key = jax.random.key(seed if seed is not None else 0)
        self._state = self.env.init(key)
        self.agents = list(self.possible_agents)
        self.agent_selection = int(self.env.current_player(self._state))
        self.rewards = {a: 0.0 for a in self.agents}
        self._cumulative_rewards = {a: 0.0 for a in self.agents}
        self.terminations = {a: False for a in self.agents}
        self.truncations = {a: False for a in self.agents}
        self.infos = {a: {"action_mask": self._mask()} for a in self.agents}

    def observe(self, agent):
        return np.asarray(self._observe(self._state))

    def state(self):
        return np.asarray(self._observe(self._state))

    def step(self, action):
        agent = self.agent_selection
        if self.terminations[agent] or self.truncations[agent]:
            # Dead-agent bookkeeping step (PettingZoo protocol).
            self._was_dead_step(action)
            return
        self._cumulative_rewards[agent] = 0.0

        self._state = self._step(self._state, jnp.int32(int(action)))

        if bool(self.env.terminal(self._state)):
            value = float(self.env.terminal_value(self._state))
            self.rewards = {0: value, 1: -value}
            self.terminations = {a: True for a in self.agents}
        else:
            self.rewards = {a: 0.0 for a in self.agents}
            self.agent_selection = int(self.env.current_player(self._state))

        mask = self._mask()
        for a in self.agents:
            self.infos[a] = {"action_mask": mask}
        self._accumulate_rewards()

    def render(self):
        if hasattr(self.env, "render"):
            return self.env.render(self._state)
        from nuzero.utils.render import render_scs_ascii

        return render_scs_ascii(self.env, self._state)

    def close(self):
        pass
