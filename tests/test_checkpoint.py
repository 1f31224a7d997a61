"""Checkpoint format gates (ref loading_utlis.py save/load semantics).

The version sidecar catches cross-version tree-layout changes; the
restore-time shape pre-check catches SAME-version leaf-shape drift — e.g.
a replay buffer whose packed SCS state dimension predates ``SCSState``'s
``vp`` field — with a clear message instead of an opaque Orbax error
(ADVICE r4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nuzero.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def test_save_restore_roundtrip(tmp_path):
    tree = {
        "params": {"w": jnp.arange(6.0).reshape(2, 3)},
        "step": jnp.int32(7),
    }
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(str(tmp_path), "auto", target=tree)
    assert step == 7
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"]), np.arange(6.0).reshape(2, 3)
    )


def test_leaf_shape_drift_rejected_with_clear_message(tmp_path):
    """A checkpoint whose buffer states have a stale packed dimension must
    fail the pre-check naming the leaf, not an Orbax internals error."""
    old = {"buffer": {"states": jnp.zeros((4, 10))}, "step": jnp.int32(1)}
    save_checkpoint(str(tmp_path), 1, old)
    new_target = {
        "buffer": {"states": jnp.zeros((4, 12))},
        "step": jnp.int32(0),
    }
    with pytest.raises(ValueError, match=r"buffer/states.*\(4, 10\).*\(4, 12\)"):
        restore_checkpoint(str(tmp_path), 1, target=new_target)


def test_format_version_gate(tmp_path):
    tree = {"step": jnp.int32(1)}
    save_checkpoint(str(tmp_path), 1, tree)
    fmt = tmp_path / "FORMAT"
    fmt.write_text("1\n")
    with pytest.raises(ValueError, match="tree-layout version 1"):
        restore_checkpoint(str(tmp_path), 1, target=tree)


def test_targetless_restore_nests_dicts_and_lists(tmp_path):
    """Without a target the tree comes back as dicts, with sequence levels
    as lists (an index that holds no leaves comes back None)."""
    tree = {"opt": ((), {"mu": jnp.ones(3)}), "step": jnp.int32(4)}
    save_checkpoint(str(tmp_path), 4, tree)
    restored, step = restore_checkpoint(str(tmp_path))
    assert step == 4
    assert restored["opt"][0] is None
    np.testing.assert_array_equal(restored["opt"][1]["mu"], np.ones(3))
    assert int(restored["step"]) == 4


def test_committed_checkpoint_matches_network_layout():
    """The committed runs restore into the network this build constructs:
    same module names, same shapes (the parameter tree of the zoo)."""
    import os

    import run as cli

    env = cli._scs_env("solo_scout_5.yml", randomize_vp=True)
    variables = cli._managers(env, "recurrent").init(jax.random.key(0))
    root = os.path.join(cli.RUNS, "scs_solo_rvp_r5", "checkpoints")
    restored, step = restore_checkpoint(root, "auto", {"params": variables})
    assert step == 300
    built = jax.tree_util.tree_flatten_with_path(variables)[0]
    loaded = jax.tree_util.tree_flatten_with_path(restored["params"])[0]
    assert [p for p, _ in built] == [p for p, _ in loaded]
    for (_, a), (_, b) in zip(built, loaded):
        assert a.shape == b.shape and b.dtype == jnp.float32
        assert not np.array_equal(np.asarray(a), np.asarray(b))  # trained
