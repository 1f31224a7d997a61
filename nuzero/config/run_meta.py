"""Run metadata: reconstruct (env, manager) for a saved run.

The reference resumes from the wizard by re-deriving the game and network
from the model directory layout plus pickled objects
(ref ``Interactive.py:126-173`` continue flows + ``search_for_config``).
Checkpoints here store only arrays (no pickled model code —
``utils/checkpoint.py``), so each run directory carries a small
``run_meta.yaml`` naming the game, scenario, and architecture; resume
rebuilds the env and network from it and restores params from the
checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from nuzero.config.yaml_io import load_yaml, save_yaml

META_FILE = "run_meta.yaml"


def save_run_meta(
    run_dir: str,
    game: str,
    arch: str,
    *,
    scenario: Optional[str] = None,
    seed: int = 42,
    hex: Optional[bool] = None,
    num_filters: int = 64,
    num_blocks: Optional[int] = None,
    randomize_vp: bool = False,
) -> str:
    """``game``: "ttt" | "scs".  ``scenario``: scenario YAML filename under
    ``configs/scenarios`` (scs only).  ``arch``: mlp | conv | recurrent |
    resnet."""
    if hex is None:
        hex = game == "scs"
    if num_blocks is None:
        num_blocks = 4 if arch == "resnet" else 2
    meta = {
        "game": game,
        "scenario": scenario,
        "seed": seed,
        "arch": arch,
        "hex": bool(hex),
        "num_filters": num_filters,
        "num_blocks": num_blocks,
        "randomize_vp": bool(randomize_vp),
    }
    path = os.path.join(run_dir, META_FILE)
    save_yaml(meta, path)
    return path


def load_run_meta(run_dir: str) -> Optional[dict]:
    path = os.path.join(run_dir, META_FILE)
    if not os.path.exists(path):
        return None
    return load_yaml(path)


def build_from_meta(meta: dict, repo_root: str) -> Tuple[object, object]:
    """(env, manager) from a ``run_meta.yaml`` dict."""
    from nuzero.networks import (
        ConvNet,
        MLPNetwork,
        NetworkManager,
        RecurrentNet,
        ResNet,
    )

    game = meta["game"]
    if game == "ttt":
        from nuzero.envs import TicTacToe

        env = TicTacToe()
    elif game == "scs":
        from nuzero.envs.scs import SCSGame, load_scenario

        scenario = load_scenario(
            os.path.join(repo_root, "configs", "scenarios", meta["scenario"]),
            seed=int(meta.get("seed", 42)),
        )
        env = SCSGame(
            scenario, randomize_vp=bool(meta.get("randomize_vp", False))
        )
    else:
        raise ValueError(f"unknown game {game!r} in run_meta")

    arch = meta["arch"]
    hex = bool(meta.get("hex", game == "scs"))
    filters = int(meta.get("num_filters", 64))
    blocks = int(meta.get("num_blocks", 2))
    if arch == "mlp":
        net = MLPNetwork(out_features=env.num_actions)
    elif arch == "conv":
        net = ConvNet(
            policy_channels=env.action_space_shape[0],
            num_filters=filters,
            num_layers=blocks,
            hex=hex,
        )
    elif arch == "recurrent":
        net = RecurrentNet(
            policy_channels=env.action_space_shape[0],
            num_filters=filters,
            num_blocks=blocks,
            hex=hex,
        )
    elif arch == "resnet":
        net = ResNet(
            policy_channels=env.action_space_shape[0],
            num_filters=filters,
            num_blocks=blocks,
            hex=hex,
        )
    else:
        raise ValueError(f"unknown arch {arch!r} in run_meta")
    return env, NetworkManager(net, env.observation_shape)
