"""Checkpointing (ref ``Utils/Functions/loading_utlis.py`` +
``Training/AlphaZero.py:157-210,453-458``).

The reference pickles model/optimizer/scheduler *objects* plus torch state
dicts per ``<name>_<step>_cp`` file and supports "auto" latest-checkpoint
discovery (``loading_utlis.py:21-27``).  Here a checkpoint is one saved
pytree — params, optimizer state, step, PRNG key, and (optionally) the
device-resident replay buffer — everything needed for bit-exact resume.
Model *code* is reconstructed from configs (saved alongside, ref
``AlphaZero.py:184-187``) rather than pickled objects.

On disk: ``<root>/step_<8 digits>/tree.npz``, one compressed NumPy array
per leaf, keyed by the leaf's path (``params/Conv_0/HexConv_0/kernel``;
sequence indices are spelled ``#<i>``), and ``<root>/FORMAT`` holding the
tree-layout version.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils

# Checkpoint tree-layout version.  Bumped when the saved pytree structure
# changes incompatibly (v2: ReplayBuffer stores packed states in a
# ``states`` field; v1 buffers stored observation tensors in ``obs``).
# Restores of a mismatched version fail with a clear message.  Same-version
# LEAF-SHAPE drift (e.g. the SCS packed replay state dimension grew when
# ``SCSState`` gained the ``vp`` field) is caught by the shape pre-check in
# :func:`restore_checkpoint` rather than by a version bump, so old
# checkpoints of unaffected games (TTT, SCS without a saved buffer) stay
# loadable.
FORMAT_VERSION = 2

_FILE = "tree.npz"


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step:08d}")


def _format_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), "FORMAT")


def _key_name(entry) -> str:
    if isinstance(entry, jax.tree_util.SequenceKey):
        return f"#{entry.idx}"
    if isinstance(entry, jax.tree_util.DictKey):
        return str(entry.key)
    if isinstance(entry, jax.tree_util.GetAttrKey):
        return entry.name
    return str(entry.key)  # FlattenedIndexKey


def _leaves_by_name(tree: Any) -> dict:
    return {
        "/".join(_key_name(e) for e in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _to_host(x) -> np.ndarray:
    """A leaf as host NumPy.  Arrays sharded across processes are
    gathered, which is a collective: every process must take part."""
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    if x.is_fully_replicated:
        return np.asarray(x.addressable_data(0))
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def save_checkpoint(root: str, step: int, tree: Any) -> str:
    """Multi-controller: EVERY process must call this with the same tree
    (leaves sharded across processes are gathered collectively); process 0
    writes the files, and all processes leave once they are written."""
    path = _ckpt_dir(root, step)
    arrays = {k: _to_host(v) for k, v in _leaves_by_name(tree).items()}
    if jax.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _FILE + ".tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, os.path.join(path, _FILE))
        with open(_format_path(root), "w") as f:
            f.write(f"{FORMAT_VERSION}\n")
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(f"checkpoint {path}")
    return path


def latest_step(root: str) -> Optional[int]:
    """'auto' discovery (ref ``loading_utlis.py:21-24``)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _nest(arrays: dict) -> Any:
    """Rebuild a tree of dicts (and lists, for ``#<i>`` levels) from
    path-keyed leaves."""
    root: dict = {}
    for name, value in arrays.items():
        node = root
        *parents, last = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.startswith("#") for k in out):
            # Indices with no leaves (empty optimizer states) come back None.
            n = 1 + max(int(k[1:]) for k in out)
            return [out.get(f"#{i}") for i in range(n)]
        return out

    return listify(root)


def restore_checkpoint(root: str, step: int | str = "auto", target: Any = None):
    """Restore the pytree saved at ``step`` ('auto' = latest).

    With a ``target``, the result has the target's structure and leaves
    as device arrays; without one, nested dicts/lists of host NumPy."""
    if step == "auto":
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _ckpt_dir(root, int(step))
    fmt_file = _format_path(root)
    if os.path.exists(fmt_file):
        with open(fmt_file) as f:
            saved_fmt = int(f.read().strip() or 0)
        if saved_fmt != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint at {path} was saved with tree-layout version "
                f"{saved_fmt}; this build reads version {FORMAT_VERSION}. "
                "Re-train or convert the run (buffer-bearing v1 checkpoints "
                "stored observations, v2 stores packed states)."
            )
    with np.load(os.path.join(path, _FILE)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    if target is None:
        return _nest(arrays), int(step)

    # Pre-check saved leaf shapes against the target so layout drift
    # (e.g. a pre-``vp`` SCS replay buffer whose packed state dimension no
    # longer matches this build's ``SCSState``) fails with a clear message
    # naming the leaves.
    wanted = _leaves_by_name(target)
    mismatches = [
        f"{name}: checkpoint {arrays[name].shape} vs this build "
        f"{tuple(np.shape(leaf))}"
        for name, leaf in sorted(wanted.items())
        if name in arrays and arrays[name].shape != tuple(np.shape(leaf))
    ]
    if mismatches:
        raise ValueError(
            f"checkpoint at {path} does not match this build's array layout: "
            + "; ".join(mismatches[:8])
            + (f" (+{len(mismatches) - 8} more)" if len(mismatches) > 8 else "")
            + ". Likely saved by an older build (e.g. an SCS replay buffer "
            "packed before SCSState gained the 'vp' field). Re-train, or "
            "restore without the stale leaves."
        )
    missing = sorted(set(wanted) - set(arrays))
    if missing:
        raise ValueError(
            f"checkpoint at {path} lacks leaves {missing[:8]} of the target"
        )
    # Leaves come back unsharded; the caller's jit/shardings place them,
    # so a restore never depends on the saving topology.
    treedef = jax.tree_util.tree_structure(target)
    leaves = [jnp.asarray(arrays[name]) for name in wanted]
    return jax.tree_util.tree_unflatten(treedef, leaves), int(step)
