"""Programmatic SCS scenario families.

The reference ships ~40 hand-written scenario YAMLs in
``Games/SCS/Game_configs/`` covering six families at board sizes 4-30
(randomized / mirrored / mirrored_plus / unbalanced / r_unbalanced /
solo_soldier; e.g. ``randomized_config_5.yml``,
``solo_soldier_config_30.yml``).  Instead of 40 copies we generate any
family at any size on demand — either as an in-memory dict fed straight to
:func:`nuzero.envs.scs.scenario.scenario_from_dict`, or written out as
YAML files compatible with the reference schema.

Family semantics (behavioral parity with the reference configs):

==============  =====================================================
randomized      2 infantry at turn 0 + 1 armor at turn 2 per side;
                4-terrain randomized map; randomized 1+1 VPs; 9 turns
mirrored        2 infantry per side at turn 0; deterministic (Detailed)
                map + VPs, identical for both players; 9 turns
mirrored_plus   mirrored + 1 extra infantry on turns 3 and 5; 9 turns
unbalanced      p1: 1 infantry, p2: 2 infantry; 7 turns
r_unbalanced    p1: 2 infantry, p2: 1 infantry; 7 turns
solo_soldier    p1: none, p2: 1 infantry; all-flat map; 7 turns —
                the DeepThinking extrapolation pathfinding task
==============  =====================================================
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, Optional

import numpy as np

from nuzero.envs.scs.scenario import Scenario, scenario_from_dict

FAMILIES = (
    "randomized",
    "mirrored",
    "mirrored_plus",
    "unbalanced",
    "r_unbalanced",
    "solo_soldier",
)

# Unit catalog: id -> (name, attack, defense, movement)
_INFANTRY = {"id": 1, "attack": 1, "defense": 1, "movement": 2}
_ARMOR = {"id": 2, "attack": 2, "defense": 2, "movement": 4}

# Four-terrain catalog used by the mixed-terrain families.
_TERRAIN4 = {
    "Marsh": {"id": 1, "attack_modifier": 0.5, "defense_modifier": 1, "cost": 2, "image_path": ""},
    "Ridge": {"id": 2, "attack_modifier": 1, "defense_modifier": 2, "cost": 2, "image_path": ""},
    "Field": {"id": 3, "attack_modifier": 1, "defense_modifier": 1, "cost": 1, "image_path": ""},
    "Grove": {"id": 4, "attack_modifier": 2, "defense_modifier": 1, "cost": 1, "image_path": ""},
}
_TERRAIN4_DIST = [0.1, 0.15, 0.65, 0.1]
_FLAT = {
    "Field": {"id": 1, "attack_modifier": 1, "defense_modifier": 1, "cost": 1, "image_path": ""},
}


def _schedule(turns: int, p1: Dict[int, list], p2: Dict[int, list]) -> dict:
    """Per-turn unit-id lists; index 0 = initial placement (turns+1 entries)."""
    return {
        "p1": [list(p1.get(t, [])) for t in range(turns + 1)],
        "p2": [list(p2.get(t, [])) for t in range(turns + 1)],
    }


def _detailed_map(size: int) -> list:
    """Deterministic mixed-terrain map for the mirrored families.

    Left-right mirror-symmetric so neither side has a terrain advantage:
    generate the left half from a size-seeded RNG with the standard terrain
    distribution, reflect it onto the right half.
    """
    rng = np.random.default_rng(size * 7919)
    ids = [_TERRAIN4[k]["id"] for k in _TERRAIN4]
    grid = rng.choice(ids, size=(size, size), p=_TERRAIN4_DIST)
    for j in range(size // 2):
        grid[:, size - 1 - j] = grid[:, j]
    # Keep the VP tiles passable flat ground.
    r = size // 2
    grid[r, 0] = grid[r, size - 1] = _TERRAIN4["Field"]["id"]
    return [[int(x) for x in row] for row in grid]


def generate_scenario(
    family: str, size: int, *, turns: Optional[int] = None
) -> dict:
    """Return a scenario config dict (reference YAML schema) for one of the
    shipped families at the given square board size."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; choose from {FAMILIES}")
    if size < 3:
        raise ValueError("board size must be >= 3")

    base = {
        "Name": f"{family}_{size}",
        "Board_dimensions": {"rows": size, "columns": size},
        "Stacking_limit": 2,
    }

    if family == "randomized":
        t = 9 if turns is None else turns
        base.update(
            Turns=t,
            Units={"Infantry": dict(_INFANTRY), "Armor": dict(_ARMOR)},
            Reinforcements={
                "schedule": _schedule(t, {0: [1, 1], 2: [2]}, {0: [1, 1], 2: [2]}),
                "arrival": {"method": "Default"},
            },
            Terrain={k: dict(v) for k, v in _TERRAIN4.items()},
            Map={"creation_method": "Randomized", "distribution": list(_TERRAIN4_DIST)},
            Victory_points={
                "creation_method": "Randomized",
                "number_vp": {"p1": 1, "p2": 1},
            },
        )
    elif family in ("mirrored", "mirrored_plus"):
        t = 9 if turns is None else turns
        if family == "mirrored":
            sched = _schedule(t, {0: [1, 1]}, {0: [1, 1]})
        else:
            sched = _schedule(t, {0: [1, 1], 3: [1], 5: [1]}, {0: [1, 1], 3: [1], 5: [1]})
        r = size // 2
        base.update(
            Turns=t,
            Units={"Infantry": dict(_INFANTRY)},
            Reinforcements={"schedule": sched, "arrival": {"method": "Default"}},
            Terrain={k: dict(v) for k, v in _TERRAIN4.items()},
            Map={
                "creation_method": "Detailed",
                "map_configuration": _detailed_map(size),
            },
            Victory_points={
                "creation_method": "Detailed",
                "vp_locations": {"p1": [[r, 0]], "p2": [[r, size - 1]]},
            },
        )
    elif family in ("unbalanced", "r_unbalanced"):
        t = 7 if turns is None else turns
        one, two = {0: [1]}, {0: [1, 1]}
        p1, p2 = (one, two) if family == "unbalanced" else (two, one)
        base.update(
            Turns=t,
            Units={"Infantry": dict(_INFANTRY)},
            Reinforcements={
                "schedule": _schedule(t, p1, p2),
                "arrival": {"method": "Default"},
            },
            Terrain={k: dict(v) for k, v in _TERRAIN4.items()},
            Map={"creation_method": "Randomized", "distribution": list(_TERRAIN4_DIST)},
            Victory_points={
                "creation_method": "Randomized",
                "number_vp": {"p1": 1, "p2": 1},
            },
        )
    elif family == "solo_soldier":
        t = 7 if turns is None else turns
        base.update(
            Stacking_limit=1,
            Turns=t,
            Units={"Infantry": dict(_INFANTRY)},
            Reinforcements={
                "schedule": _schedule(t, {}, {0: [1]}),
                "arrival": {"method": "Default"},
            },
            Terrain={k: dict(v) for k, v in _FLAT.items()},
            Map={"creation_method": "Randomized", "distribution": [1]},
            Victory_points={
                "creation_method": "Randomized",
                "number_vp": {"p1": 1, "p2": 1},
            },
        )
    return base


def make_scenario(family: str, size: int, seed=None, *, turns=None) -> Scenario:
    """Generate + pack in one call (no YAML round-trip)."""
    return scenario_from_dict(generate_scenario(family, size, turns=turns), seed)


def write_scenario_suite(
    outdir: str,
    families: Iterable[str] = FAMILIES,
    sizes: Iterable[int] = tuple(range(4, 11)),
    solo_sizes: Iterable[int] = tuple(range(4, 21)) + (30,),
) -> list:
    """Emit the full family x size grid as YAML files (reference parity:
    the ``Games/SCS/Game_configs/`` directory contents)."""
    import yaml

    os.makedirs(outdir, exist_ok=True)
    written = []
    for family in families:
        for size in solo_sizes if family == "solo_soldier" else sizes:
            path = os.path.join(outdir, f"{family}_{size}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(
                    generate_scenario(family, size), f, sort_keys=False
                )
            written.append(path)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outdir", default="configs/scenarios/generated")
    ap.add_argument("--families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--sizes", nargs="*", type=int, default=list(range(4, 11)))
    args = ap.parse_args(argv)
    paths = write_scenario_suite(args.outdir, args.families, args.sizes)
    print(f"wrote {len(paths)} scenarios to {args.outdir}")


if __name__ == "__main__":
    main()
