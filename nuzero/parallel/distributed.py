"""Multi-host initialization (ref ``Utils/Functions/ray_utils.py`` +
``SLURM/`` scripts).

The reference bootstraps a Ray cluster (head + workers, code shipped via
RuntimeEnv) before running the driver (``ray_utils.py:6-40``,
``slurm-template.sh:52-66``).  The equivalent here is JAX
multi-controller: every host runs the SAME program, one process per host
driving all of that host's GPUs; ``jax.distributed.initialize`` wires the
coordinator, after which ``jax.devices()`` spans every host's cards and all
cross-device communication happens through XLA collectives (NCCL over
NVLink within a host, the network between hosts) — there is no object
store and no parameter shipping (SURVEY §2.8).
"""

from __future__ import annotations

import os
from typing import Optional


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize JAX multi-controller.

    With no arguments, relies on JAX's built-in cluster auto-detection
    (SLURM and other launchers JAX recognizes).  Explicit arguments
    override for bespoke launchers; ``JAX_COORDINATOR`` env is honored.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR"
    )
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_multi_host() -> bool:
    import jax

    return jax.process_count() > 1


def local_shard(global_batch: int) -> int:
    """Per-host slice of a globally-sized batch."""
    import jax

    n = jax.process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n
