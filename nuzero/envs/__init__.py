from nuzero.envs.base import Env
from nuzero.envs.tictactoe import TicTacToe, TTTState

__all__ = ["Env", "TicTacToe", "TTTState"]
