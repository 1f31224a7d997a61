from nuzero.envs.scs.scenario import Scenario, load_scenario, scenario_from_dict
from nuzero.envs.scs.scenario_gen import FAMILIES, generate_scenario, make_scenario
from nuzero.envs.scs.game import SCSGame, SCSState

__all__ = [
    "SCSGame",
    "SCSState",
    "Scenario",
    "load_scenario",
    "scenario_from_dict",
    "generate_scenario",
    "make_scenario",
    "FAMILIES",
]
