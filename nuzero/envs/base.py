"""Environment contract for pure-JAX game engines.

The reference defines an informal Python-object ``Game`` interface with
mutating methods (``possible_actions``, ``step``, ``generate_network_input``,
``is_terminal``, ... — ref ``Games/Game.py:3-106``).  This design
replaces it with a *functional* contract: the environment object holds only
static scenario data; all dynamic state lives in an immutable pytree
(struct-of-arrays) so that thousands of boards can be stepped in lockstep
under ``jax.vmap`` + ``jax.jit``.

Every method is pure and shape-static:

- ``init(key) -> state`` replaces ``reset`` (ref ``Games/Game.py``); randomness
  (e.g. randomized SCS maps) is threaded through the PRNG key.
- ``step(state, action) -> state`` consumes a flat action index; it must be
  total (defined even for illegal actions / terminal states) — legality is
  enforced by masking at the call site, never by raising.
- ``legal_mask(state) -> bool[num_actions]`` replaces ``possible_actions``.
- ``observe(state) -> f32[C, H, W]`` replaces ``generate_network_input``
  (without the batch dim: batching is vmap's job).
- ``terminal(state) -> bool`` and ``terminal_value(state) -> f32`` expose the
  static-value convention (+1 = player 0 wins).
- ``current_player(state) -> i32`` in {0, 1}.

Environments are registered by name so configs can refer to them.
"""

from __future__ import annotations

import abc
from typing import Any, ClassVar, Dict, Tuple, Type

import jax

EnvState = Any  # a pytree (utils.struct dataclass) specific to each Env


class Env(abc.ABC):
    """Static environment description + pure transition functions."""

    # Registry of concrete env classes by name (used by the config system).
    _registry: ClassVar[Dict[str, Type["Env"]]] = {}

    #: flat action count == prod(action_space_shape)
    num_actions: int
    #: (planes, rows, cols) layout of the flat action index (C-order ravel)
    action_space_shape: Tuple[int, int, int]
    #: (channels, rows, cols) observation shape
    observation_shape: Tuple[int, int, int]
    #: hard upper bound on game length in decisions (for buffers/scans)
    max_game_length: int

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        Env._registry[cls.__name__] = cls

    @classmethod
    def registry(cls) -> Dict[str, Type["Env"]]:
        return dict(cls._registry)

    # ---- pure functions over state pytrees --------------------------------

    @abc.abstractmethod
    def init(self, key: jax.Array) -> EnvState:
        """Fresh game state (player 0 to move)."""

    @abc.abstractmethod
    def step(self, state: EnvState, action: jax.Array) -> EnvState:
        """Apply a flat action index.  Total function; no-op on terminal
        states is NOT required — callers must not step terminal games."""

    @abc.abstractmethod
    def legal_mask(self, state: EnvState) -> jax.Array:
        """bool[num_actions]; True = legal in the current sub-phase."""

    @abc.abstractmethod
    def observe(self, state: EnvState) -> jax.Array:
        """f32[channels, rows, cols] network input."""

    @abc.abstractmethod
    def terminal(self, state: EnvState) -> jax.Array:
        """bool scalar."""

    @abc.abstractmethod
    def terminal_value(self, state: EnvState) -> jax.Array:
        """f32 scalar in [-1, 1]; +1 = player 0 won.  0 until terminal."""

    @abc.abstractmethod
    def current_player(self, state: EnvState) -> jax.Array:
        """i32 scalar in {0, 1}."""

    # ---- conveniences ------------------------------------------------------

    def action_coords(self, action: jax.Array):
        """Flat index -> (plane, row, col) (ref Games/Game.py:96-102)."""
        import jax.numpy as jnp

        p, r, c = self.action_space_shape
        return jnp.unravel_index(action, (p, r, c))

    def action_index(self, plane, row, col):
        import jax.numpy as jnp

        return jnp.ravel_multi_index(
            (plane, row, col), self.action_space_shape, mode="clip"
        )
