from nuzero.training.replay import ReplayBuffer, FinishedGames
from nuzero.training.selfplay import SelfplayState, make_selfplay_step
from nuzero.training.learner import Learner, LearnerConfig, TrainState
from nuzero.training.pipeline import AlphaZero

__all__ = [
    "AlphaZero",
    "FinishedGames",
    "Learner",
    "LearnerConfig",
    "ReplayBuffer",
    "SelfplayState",
    "TrainState",
    "make_selfplay_step",
]
