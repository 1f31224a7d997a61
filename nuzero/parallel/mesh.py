"""Device mesh + sharding placements for the dp actor-learner.

The reference's parallelism is process-level: Ray Gamer actors spread over
nodes, a single-process learner, and pickled-weight shipping through the
object store (SURVEY §2.8).  Here the layout is single-program
multi-device:

- one ``Mesh`` with a plain 1-D ``dp`` axis over all cards (NVLink joins
  a host's cards all to all, so no topology is needed);
- the self-play game batch and the replay buffer's game axis are sharded
  over ``dp`` (each card owns its shard of games — the moral equivalent of
  ``SPREAD`` Ray actors, but in one XLA program);
- network parameters and optimizer state are replicated; the gradient
  all-reduce that data-parallel training needs is inserted by XLA from the
  sharding annotations;
- weights never leave device: the reference's ``RemoteStorage`` network
  shipping (``AlphaZero.py:291-294``) has no equivalent because actors and
  learner literally share the arrays.

TP/PP/SP/EP are deliberate non-goals: the model zoo tops out at ~256-filter
convnets that fit trivially per card (SURVEY §2.8); the scaling axes that
matter here are game batch and replay, both on ``dp``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None, axis: str = "dp") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_batch(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Leading-axis sharding for game batches / replay game slots."""
    return NamedSharding(mesh, P(axis))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _to_global(x, sharding: NamedSharding):
    """Commit a host/local value to a (possibly cross-process) sharding.

    Single-process: plain ``device_put``.  Multi-controller:
    ``device_put`` onto a sharding that spans non-addressable devices is
    illegal, so the value goes through
    ``jax.make_array_from_process_local_data`` with the FULL global shape —
    every process passes the same full-size host value (callers compute
    initial state deterministically from the run seed, so all processes
    agree) and JAX slices out each process's addressable shards.
    """
    if jax.process_count() > 1:
        import jax.numpy as jnp

        dtype = getattr(x, "dtype", None)
        if dtype is not None and jnp.issubdtype(dtype, jax.dtypes.prng_key):
            # Typed PRNG keys can't cross the host boundary directly:
            # place the raw key data (same leading-axis sharding; the
            # trailing key-data dims stay unsharded) and re-wrap.
            impl = jax.random.key_impl(x)
            data = np.asarray(jax.random.key_data(x))
            g = jax.make_array_from_process_local_data(
                sharding, data, data.shape
            )
            return jax.random.wrap_key_data(g, impl=impl)
        x_np = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sharding, x_np, x_np.shape
        )
    return jax.device_put(x, sharding)


def place_replicated(tree: Any, mesh: Mesh) -> Any:
    """Place every leaf replicated over the mesh (params, opt state)."""
    repl = replicate(mesh)
    return jax.tree.map(lambda x: _to_global(x, repl), tree)


def place_batch_sharded(tree: Any, mesh: Mesh) -> Any:
    """Place leaves sharded on their leading (game/batch) axis when it
    divides the mesh; scalars and indivisible leaves are replicated.

    This is the committed-input placement for the self-play state and the
    replay buffer: each device owns its shard of games — the moral
    equivalent of the reference's ``SPREAD`` Ray actors
    (``Training/Gamer.py:17``) but inside one XLA program (and, across
    hosts, the equivalent of the reference's multi-node Ray cluster,
    ``SLURM/slurm-template.sh:52-63``).
    """
    repl = replicate(mesh)
    shard = shard_batch(mesh)
    n_dev = mesh.size

    def put(x):
        if getattr(x, "shape", None) is None:
            x = np.asarray(x)
        if x.ndim >= 1 and x.shape[0] > 0 and x.shape[0] % n_dev == 0:
            return _to_global(x, shard)
        return _to_global(x, repl)

    return jax.tree.map(put, tree)
