"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass whose fields are all pytree
leaves (registered with ``jax.tree_util.register_dataclass``) and gives it
a ``replace(**changes)`` method, so state containers flow through ``jit``,
``vmap``, ``lax.scan`` and shardings like tuples do.
"""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
