"""Bulk config-migration helpers (ref Utils/Functions/yaml_utils.py:24-75)."""

import os

from nuzero.config import (
    insert_in_all_configs,
    load_training_config,
    remove_from_all_configs,
)
from nuzero.config.yaml_io import load_yaml, save_yaml


def _write_two_configs(d):
    for name, steps in (("a.yaml", 10), ("b.yml", 20)):
        save_yaml(
            {"Running": {"training_steps": steps}, "Learning": {}},
            str(d / name),
        )


def test_insert_in_all_configs(tmp_path):
    _write_two_configs(tmp_path)
    n = insert_in_all_configs(str(tmp_path), ["Running"], "num_actors", 64)
    assert n == 2
    for name in ("a.yaml", "b.yml"):
        data = load_yaml(str(tmp_path / name))
        assert data["Running"]["num_actors"] == 64
    # The migrated configs still load through the real parser.
    cfg = load_training_config(str(tmp_path / "a.yaml"))
    assert cfg.running.num_actors == 64
    assert cfg.running.training_steps == 10


def test_remove_from_all_configs(tmp_path):
    _write_two_configs(tmp_path)
    insert_in_all_configs(str(tmp_path), ["Running"], "stale_knob", 1)
    n = remove_from_all_configs(str(tmp_path), ["Running"], "stale_knob")
    assert n == 2
    for name in ("a.yaml", "b.yml"):
        assert "stale_knob" not in load_yaml(str(tmp_path / name))["Running"]


def test_missing_section_untouched(tmp_path):
    save_yaml({"Other": {}}, str(tmp_path / "c.yaml"))
    assert insert_in_all_configs(str(tmp_path), ["Running"], "x", 1) == 0
    assert remove_from_all_configs(str(tmp_path), ["Running"], "x") == 0
