"""Gather-free small-domain lookups.

When the indexed axis is SMALL and static, a lookup can be an unrolled
select chain that fuses into one elementwise pass instead of a dynamic
gather.  The system was first built for an accelerator that executed
per-element dynamic gathers serially; on the GPU a gather is a native
load, and which of the two wins there is not yet measured (ROADMAP 1.3).
Used by the SCS engine (unit/board tables) and the MCTS descent
(per-node scalars).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# Above this first-axis size the unrolled chain stops paying: the select
# dag bloats the HLO (compile time grows superlinearly inside loop bodies)
# and the O(N) compares approach a gather's cost anyway.  Tuned on the
# earlier accelerator; not yet measured on the GPU.
CHAIN_LIMIT = 96


def take_small(table: jax.Array, idx: jax.Array) -> jax.Array:
    """``table[idx]`` without a serialized gather.

    - Scalar ``idx``: a masked reduction over the first axis — one fused
      pass, ANY table size, constant HLO size.  (Under vmap the mask
      batches to [B, N]; still one pass.)
    - Array ``idx``: an unrolled select chain — O(len(table)) fused
      compares per element, profitable up to ~100 entries; larger tables
      fall back to a plain gather.

    ``idx`` must be in range (clamp first); out-of-range yields 0.
    Trailing table axes broadcast."""
    idx = jnp.asarray(idx)
    if idx.ndim == 0:
        mask = (jnp.arange(table.shape[0]) == idx).reshape(
            (-1,) + (1,) * (table.ndim - 1)
        )
        return jnp.where(mask, table, 0).sum(0).astype(table.dtype)
    if table.shape[0] > CHAIN_LIMIT:
        return table[idx]
    flat = table.reshape(table.shape[0], -1) if table.ndim > 1 else table
    out = jnp.zeros(idx.shape + flat.shape[1:], flat.dtype)
    for k in range(table.shape[0]):
        row = flat[k]
        out = jnp.where(
            (idx == k).reshape(idx.shape + (1,) * (flat.ndim - 1)), row, out
        )
    if table.ndim > 1:
        return out.reshape(idx.shape + table.shape[1:])
    return out


def pick_at(row: jax.Array, idx: jax.Array) -> jax.Array:
    """``row[idx]`` along a (possibly large) last axis as a masked
    reduction — one fused pass, no serial gather.  ``row`` may have
    leading batch dims; ``idx`` scalar (or matching leading dims)."""
    iota = jnp.arange(row.shape[-1])
    mask = iota == jnp.asarray(idx)[..., None]
    return jnp.where(mask, row, 0).sum(-1).astype(row.dtype)
