"""Tic-Tac-Toe as a pure-JAX state machine.

Behavioral target: ``Games/Tic_Tac_Toe/tic_tac_toe.py`` in the reference,
re-expressed functionally:

- 3x3 board, marks stored as {0 empty, 1 player-0, 2 player-1}
  (the reference labels players {1, 2}; we relabel to the framework-wide
  {0, 1} convention — ref ``tic_tac_toe.py:27``).
- player to move = length % 2 (ref ``tic_tac_toe.py:165``).
- observation = 2 planes: player-0 pieces, player-1 pieces
  (ref ``generate_state_image``, ``tic_tac_toe.py:135-159``).
- terminal: any 3-line for either player, or length == 9
  (ref ``check_terminal``, ``tic_tac_toe.py:198-262``).
- terminal value: +1 player-0 win / -1 player-1 win / 0 draw — static
  convention (ref ``tic_tac_toe.py:242-255``).

The win check is vectorized: one-hot the mover's marks and reduce the 8 lines
with a single (9, 8) mask matmul instead of the reference's scalar loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from nuzero.utils import struct

from nuzero.envs.base import Env

# (8 lines, 9 cells): rows, cols, two diagonals.
_LINES = np.zeros((8, 9), dtype=np.float32)
for _i in range(3):
    _LINES[_i, 3 * _i : 3 * _i + 3] = 1.0  # rows
    _LINES[3 + _i, _i::3] = 1.0  # cols
_LINES[6, [0, 4, 8]] = 1.0  # main diagonal
_LINES[7, [2, 4, 6]] = 1.0  # anti-diagonal


@struct.dataclass
class TTTState:
    board: jax.Array  # i8[3, 3]; 0 empty, 1 = player 0's mark, 2 = player 1's
    current_player: jax.Array  # i32 in {0, 1}
    length: jax.Array  # i32 moves played
    terminal: jax.Array  # bool
    terminal_value: jax.Array  # f32; +1 = player 0 won


class TicTacToe(Env):
    num_actions = 9
    action_space_shape = (1, 3, 3)
    observation_shape = (2, 3, 3)
    max_game_length = 9

    def init(self, key: jax.Array | None = None) -> TTTState:
        del key  # deterministic start
        return TTTState(
            board=jnp.zeros((3, 3), jnp.int8),
            current_player=jnp.int32(0),
            length=jnp.int32(0),
            terminal=jnp.bool_(False),
            terminal_value=jnp.float32(0.0),
        )

    def step(self, state: TTTState, action: jax.Array) -> TTTState:
        row, col = action // 3, action % 3
        mark = (state.current_player + 1).astype(jnp.int8)
        board = state.board.at[row, col].set(mark)
        length = state.length + 1

        flat = board.reshape(9)
        mover_line = (
            (_LINES @ (flat == mark).astype(jnp.float32)).max() >= 3.0
        )
        # Only the mover can complete a line on their own move.
        won_value = jnp.where(state.current_player == 0, 1.0, -1.0)
        terminal = mover_line | (length >= 9)
        terminal_value = jnp.where(mover_line, won_value, 0.0)

        return TTTState(
            board=board,
            current_player=(length % 2).astype(jnp.int32),
            length=length,
            terminal=terminal,
            terminal_value=terminal_value,
        )

    def legal_mask(self, state: TTTState) -> jax.Array:
        return (state.board.reshape(9) == 0) & ~state.terminal

    def observe(self, state: TTTState) -> jax.Array:
        p0 = (state.board == 1).astype(jnp.float32)
        p1 = (state.board == 2).astype(jnp.float32)
        return jnp.stack([p0, p1], axis=0)

    def terminal(self, state: TTTState) -> jax.Array:
        return state.terminal

    def terminal_value(self, state: TTTState) -> jax.Array:
        return state.terminal_value

    def current_player(self, state: TTTState) -> jax.Array:
        return state.current_player

    # ---- host-side helpers -------------------------------------------------

    @staticmethod
    def render(state: TTTState) -> str:
        """ASCII board (ref ``tic_tac_toe.py:275-297``, sans colors)."""
        chars = {0: "   ", 1: " O ", 2: " X "}
        board = np.asarray(state.board)
        rows = ["|".join(chars[int(v)] for v in r) for r in board]
        return ("\n---|---|---\n").join(rows) + "\n"
