from nuzero.evaluation.agents import (
    Agent,
    GoalRushAgent,
    MctsAgent,
    PolicyAgent,
    RandomAgent,
)
from nuzero.evaluation.arena import MatchStats, play_matches
from nuzero.evaluation.human import play_vs_agent
from nuzero.evaluation.manager import TestManager
from nuzero.evaluation.state_sets import (
    STATE_SET_BUILDERS,
    build_state_set,
    mirrored_state_set,
    r_unbalanced_state_set,
    solo_state_set,
    unbalanced_state_set,
)

__all__ = [
    "Agent",
    "GoalRushAgent",
    "MatchStats",
    "MctsAgent",
    "PolicyAgent",
    "RandomAgent",
    "STATE_SET_BUILDERS",
    "TestManager",
    "build_state_set",
    "mirrored_state_set",
    "play_matches",
    "play_vs_agent",
    "r_unbalanced_state_set",
    "solo_state_set",
    "unbalanced_state_set",
]
