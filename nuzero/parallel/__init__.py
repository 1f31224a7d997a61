from nuzero.parallel.mesh import (
    make_mesh,
    place_batch_sharded,
    place_replicated,
    shard_batch,
    replicate,
)

__all__ = [
    "make_mesh",
    "place_batch_sharded",
    "place_replicated",
    "replicate",
    "shard_batch",
]
