"""NuZero: an accelerator-native AlphaZero framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
guilherme439/NuZero (an AlphaZero system for SCS hex-grid wargames and
Tic-Tac-Toe with DeepThinking recurrent networks):

- Game engines are pure-JAX state machines (struct-of-array pytrees) stepped
  for thousands of boards in lockstep under ``jit``/``vmap``
  (ref: ``Games/Game.py``, ``Games/SCS/SCS_Game.py``).
- MCTS is a fully-batched array tree (no Python node objects), with all leaf
  evaluations batched across games into one network call per simulation
  (ref: ``Search/Explorer.py``, ``Search/Node.py``).
- Networks are small plain-JAX modules (``networks/core.py``); hexagonal
  convolution (HexagDLy semantics) is a parity-masked dual convolution; the
  DeepThinking recurrence is a ``lax.scan`` (ref: ``Neural_Networks/``).
- The Ray actor-learner pipeline becomes an on-device self-play -> replay ->
  SGD loop, sharded over a ``jax.sharding.Mesh`` for multi-device
  (ref: ``Training/AlphaZero.py``, ``Training/Gamer.py``).

Conventions (framework-wide):

- Players are ``0`` and ``1``. ``0`` moves first.
- Values are *static*: ``+1`` means player 0 ultimately wins, ``-1`` means
  player 1 wins, ``0`` is a draw, regardless of whose turn it is.  This
  matches the reference's static value convention (ref ``README.md:139``),
  with one deliberate fix: search always negates the value term for player
  1's decisions (the reference's sign flip keyed on ``to_play == 2`` never
  fired for SCS games whose players are labelled {0,1};
  ref ``Search/Explorer.py:124``).
- Actions are flat ``int32`` indices into an ``(planes, rows, cols)`` action
  space, C-order raveled (ref ``Games/Game.py:96-102``).
- Observations are ``(channels, rows, cols)`` float arrays; batch dims lead.
"""

__version__ = "0.1.0"
