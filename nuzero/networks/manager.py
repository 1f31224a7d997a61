"""Unified network front-end (ref ``Neural_Networks/Network_Manager.py``).

The reference's ``Network_Manager`` wraps a torch module, handles device
placement, and dispatches recurrent vs feed-forward inference
(``Network_Manager.py:46-64``).  In JAX there is no mutable module/device
state: the manager binds a module definition (``networks/core.py``) and
exposes pure ``init``/``apply`` functions; parameters are explicit pytrees that live
wherever the caller's shardings put them (device placement is the mesh's
job, not the manager's).

``apply`` has one uniform signature for the whole zoo:

    (variables, obs, iters_to_do, interim_thought, train)
        -> (policy_logits, value, interim_thought | None)

so search/training code never branches on architecture.  ``inference``
mirrors the reference's return conventions for parity.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from nuzero.networks import core as nn


class NetworkManager:
    def __init__(self, module: nn.Module, observation_shape: Tuple[int, ...]):
        self.module = module
        self.observation_shape = tuple(observation_shape)
        if not hasattr(module, "recurrent") or not isinstance(
            module.recurrent, bool
        ):
            # ref Network_Manager.py:20-24 — the attr is mandatory.
            raise TypeError(
                "network modules must define a boolean `recurrent` attribute"
            )

    @property
    def is_recurrent(self) -> bool:
        return self.module.recurrent

    def init(self, key: jax.Array) -> Any:
        obs = jnp.zeros((1,) + self.observation_shape, jnp.float32)
        if self.is_recurrent:
            return self.module.init(key, obs, 1)
        return self.module.init(key, obs)

    def apply(
        self,
        variables: Any,
        obs: jax.Array,
        iters_to_do: int = 2,
        interim_thought: Optional[jax.Array] = None,
        train: bool = False,
    ) -> Tuple[jax.Array, jax.Array, Optional[jax.Array]]:
        """Uniform forward: -> (policy_logits [B, A], value [B], interim)."""
        if self.is_recurrent:
            (p, v), interim = self.module.apply(
                variables, obs, iters_to_do, interim_thought, train
            )
            return p, v, interim
        p, v = self.module.apply(variables, obs, train=train)
        return p, v, None

    def inference(
        self,
        variables: Any,
        obs: jax.Array,
        training: bool = False,
        iters_to_do: int = 2,
        interim_thought: Optional[jax.Array] = None,
    ):
        """Reference-parity return shape (ref ``Network_Manager.py:46-64``):
        ``(p, v)`` normally; ``((p, v), interim)`` for recurrent training."""
        p, v, interim = self.apply(
            variables, obs, iters_to_do, interim_thought, train=training
        )
        if self.is_recurrent and training:
            return (p, v), interim
        return p, v

    def param_count(self, variables: Any) -> int:
        return sum(x.size for x in jax.tree.leaves(variables))
