"""PettingZoo AEC environment-contract tests (ref ``Run.py:328-345``:
the reference runs ``pettingzoo.test.api_test`` over SCS_Game)."""

import numpy as np
import pytest

pytest.importorskip("pettingzoo")

from nuzero.envs import TicTacToe
from nuzero.envs.aec import AECAdapter


def _random_aec_playout(aec, seed):
    aec.reset(seed=seed)
    rng = np.random.default_rng(seed)
    steps = 0
    totals = {a: 0.0 for a in aec.agents}
    for agent in aec.agent_iter(max_iter=2000):
        obs, reward, terminated, truncated, info = aec.last()
        totals[agent] += reward
        if terminated or truncated:
            aec.step(None)
            continue
        mask = info["action_mask"]
        action = int(rng.choice(np.flatnonzero(mask)))
        aec.step(action)
        steps += 1
    return steps, totals


def test_ttt_aec_playout():
    aec = AECAdapter(TicTacToe())
    steps, totals = _random_aec_playout(aec, 0)
    assert 5 <= steps <= 9
    assert aec.agents == []  # all agents terminated and removed
    assert totals[0] == -totals[1]  # zero-sum


def test_scs_aec_playout():
    from nuzero.envs.scs import SCSGame, load_scenario

    scn = load_scenario("/root/repo/configs/scenarios/open_field_5.yml", seed=1)
    aec = AECAdapter(SCSGame(scn))
    steps, totals = _random_aec_playout(aec, 2)
    assert steps > 10
    assert aec.agents == []
    assert totals[0] == -totals[1]


def test_pettingzoo_api_test():
    from pettingzoo.test import api_test

    aec = AECAdapter(TicTacToe())
    api_test(aec, num_cycles=20, verbose_progress=False)
