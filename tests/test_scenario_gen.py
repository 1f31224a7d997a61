"""Scenario-family generator: every family x size loads, packs, and plays.

Parity target: the reference's shipped scenario grid in
``Games/SCS/Game_configs/`` (randomized/mirrored/mirrored_plus/unbalanced/
r_unbalanced/solo_soldier at sizes 4-30).
"""

import numpy as np
import pytest

from nuzero.envs.scs import FAMILIES, SCSGame, make_scenario, scenario_from_dict
from nuzero.envs.scs.scenario_gen import generate_scenario, write_scenario_suite


@pytest.mark.parametrize("family", FAMILIES)
def test_family_packs_and_inits(family):
    sc = make_scenario(family, 5, seed=42)
    assert sc.rows == sc.cols == 5
    game = SCSGame(sc)
    state = game.init(None)
    mask = np.asarray(game.legal_mask(state))
    assert mask.any(), f"{family}: no legal action at the initial state"


def test_unit_counts_per_family():
    expect = {
        "randomized": (3, 3),
        "mirrored": (2, 2),
        "mirrored_plus": (4, 4),
        "unbalanced": (1, 2),
        "r_unbalanced": (2, 1),
        "solo_soldier": (0, 1),
    }
    for family, (p1, p2) in expect.items():
        sc = make_scenario(family, 6, seed=1)
        assert tuple(sc.reinf_count.tolist()) == (p1, p2), family


def test_mirrored_map_is_symmetric_and_deterministic():
    a = make_scenario("mirrored", 8)
    b = make_scenario("mirrored", 8)
    np.testing.assert_array_equal(a.terrain_cost, b.terrain_cost)
    np.testing.assert_array_equal(a.terrain_cost, a.terrain_cost[:, ::-1])
    np.testing.assert_array_equal(a.vp[0], a.vp[1][:, ::-1])


def test_solo_soldier_turns_fixed_across_sizes():
    for size in (5, 10, 16):
        sc = make_scenario("solo_soldier", size, seed=3)
        assert sc.turns == 7
        assert sc.stacking_limit == 1


def test_randomized_is_seed_reproducible():
    a = make_scenario("randomized", 7, seed=99)
    b = make_scenario("randomized", 7, seed=99)
    np.testing.assert_array_equal(a.terrain_attack, b.terrain_attack)
    np.testing.assert_array_equal(a.vp, b.vp)
    c = make_scenario("randomized", 7, seed=100)
    assert not np.array_equal(a.terrain_attack, c.terrain_attack) or not np.array_equal(
        a.vp, c.vp
    )


def test_yaml_round_trip_matches_in_memory(tmp_path):
    import yaml

    paths = write_scenario_suite(
        str(tmp_path), families=("randomized", "solo_soldier"), sizes=(5,), solo_sizes=(5,)
    )
    assert len(paths) == 2
    for p in paths:
        with open(p) as f:
            data = yaml.safe_load(f)
        sc_file = scenario_from_dict(data, seed=7)
        sc_mem = scenario_from_dict(
            generate_scenario(data["Name"].rsplit("_", 1)[0], 5), seed=7
        )
        np.testing.assert_array_equal(sc_file.terrain_cost, sc_mem.terrain_cost)
        np.testing.assert_array_equal(sc_file.reinf_stats, sc_mem.reinf_stats)
