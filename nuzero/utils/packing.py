"""Pack arbitrary env-state pytrees into flat f32 vectors.

Why this exists: MCTS stores an env state per tree node.  Storing the raw
pytree gives many arrays like ``[B, nodes, 5, 5, K]`` with small trailing
dims, which accelerators lay out padded to their tile sizes.  Packing
every state into one ``[D]`` f32 vector makes node storage one
``[B, nodes, D]`` array with a large minor dim.

Exactness: int/bool leaves are value-cast to f32, which is exact for
magnitudes < 2^24 — true for every field in this framework's envs (board
indices, counters, flags; the largest sentinel is 10^6).  A packer checks
leaf dtypes on construction.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_OK_DTYPES = {
    jnp.dtype(jnp.float32),
    jnp.dtype(jnp.int32),
    jnp.dtype(jnp.int8),
    jnp.dtype(bool),
}


def make_packer(
    template: Any,
) -> Tuple[Callable[[Any], jax.Array], Callable[[jax.Array], Any], int]:
    """Build (pack, unpack, dim) for states shaped like ``template``."""
    leaves, treedef = jax.tree.flatten(template)
    specs = []
    offset = 0
    for leaf in leaves:
        leaf = jnp.asarray(leaf)
        if leaf.dtype not in _OK_DTYPES:
            raise TypeError(f"unpackable leaf dtype {leaf.dtype}")
        size = int(np.prod(leaf.shape)) if leaf.shape else 1
        specs.append((leaf.shape, leaf.dtype, offset, size))
        offset += size
    dim = offset

    def pack(state) -> jax.Array:
        parts = []
        for leaf in jax.tree.leaves(state):
            parts.append(jnp.asarray(leaf, jnp.float32).reshape(-1))
        return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.float32)

    def unpack(vec: jax.Array):
        out = []
        for shape, dtype, off, size in specs:
            part = jax.lax.dynamic_slice_in_dim(vec, off, size, axis=0)
            part = part.reshape(shape) if shape else part[0]
            if dtype == jnp.dtype(bool):
                part = part != 0
            else:
                part = part.astype(dtype)
            out.append(part)
        return jax.tree.unflatten(treedef, out)

    return pack, unpack, dim
