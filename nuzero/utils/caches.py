"""Inference caches (ref ``Utils/Caches/``).

On-device batched MCTS doesn't need host inference caches in the hot path
(leaf evaluations are already fused into large batched calls), but the cache
subsystem remains part of the framework surface for host-driven agents and
tooling parity:

- ``DictCache``: dict keyed by the flattened state bytes; evicts 10% when
  full; merge via update; hit/miss stats; update threshold 0.7
  (ref ``Utils/Caches/DictCache.py``).
- ``KeylessCache``: stores NO keys — the state hash is split into a table
  index and an identifier; direct-mapped with silent overwrite on
  collisions; power-of-2 sizing; slot-wise merge; update threshold 0.8
  (ref ``Utils/Caches/KeylessCache.py``).  Hashing uses the native
  xxhash64 extension (replacing the reference's metrohash C extension).
- ``create_cache`` factory (ref ``Utils/Functions/general_utils.py:13-22``).
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

import numpy as np

from nuzero.native import xxh64


def _state_bytes(state) -> bytes:
    arr = np.asarray(state)
    return np.ascontiguousarray(arr).tobytes()


class Cache(abc.ABC):
    """(ref ``Utils/Caches/Cache.py``)."""

    update_threshold: float = 0.7

    def __init__(self):
        self.hits = 0
        self.misses = 0

    @abc.abstractmethod
    def get(self, state) -> Optional[Any]: ...

    @abc.abstractmethod
    def put(self, entry: Tuple[Any, Any]) -> None: ...

    @abc.abstractmethod
    def update(self, other: "Cache") -> None: ...

    @abc.abstractmethod
    def clear(self) -> None: ...

    @abc.abstractmethod
    def length(self) -> int: ...

    @abc.abstractmethod
    def max_length(self) -> int: ...

    def fill_ratio(self) -> float:
        return self.length() / max(self.max_length(), 1)

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def should_update(self) -> bool:
        """Gossip-merge gate (ref cache ``update`` thresholds)."""
        return self.fill_ratio() < self.update_threshold


class DictCache(Cache):
    update_threshold = 0.7

    def __init__(self, max_size: int = 10000):
        super().__init__()
        self.max_size = max_size
        self._table = {}

    def get(self, state):
        key = _state_bytes(state)
        result = self._table.get(key)
        if result is None:
            self.misses += 1
        else:
            self.hits += 1
        return result

    def put(self, entry):
        key_state, value = entry
        if len(self._table) >= self.max_size:
            # Evict 10% oldest (ref DictCache.py:37-51).
            n_evict = max(self.max_size // 10, 1)
            for k in list(self._table.keys())[:n_evict]:
                del self._table[k]
        self._table[_state_bytes(key_state)] = value

    def update(self, other: "DictCache"):
        self._table.update(other._table)

    def clear(self):
        self._table.clear()

    def length(self):
        return len(self._table)

    def max_length(self):
        return self.max_size


class KeylessCache(Cache):
    update_threshold = 0.8

    def __init__(self, max_size: int = 10000):
        super().__init__()
        # Power-of-2 sizing (ref KeylessCache.py:152-159).
        size = 1
        while size * 2 <= max_size:
            size *= 2
        self.size = size
        self._index_bits = size.bit_length() - 1
        self._ident = np.zeros(size, np.uint64)  # 0 = empty
        self._values = [None] * size

    def _locate(self, state):
        h = np.uint64(xxh64(_state_bytes(state)))
        index = int(h & np.uint64(self.size - 1))
        ident = (h >> np.uint64(self._index_bits)) | np.uint64(1)
        return index, ident

    def get(self, state):
        index, ident = self._locate(state)
        if self._ident[index] == ident:
            self.hits += 1
            return self._values[index]
        self.misses += 1
        return None

    def put(self, entry):
        key_state, value = entry
        index, ident = self._locate(key_state)
        # Silent overwrite on collision (ref KeylessCache.py:74-85).
        self._ident[index] = ident
        self._values[index] = value

    def update(self, other: "KeylessCache"):
        # Slot-wise overwrite merge (ref KeylessCache.py:87-103).
        if other.size != self.size:
            raise ValueError("can only merge equally-sized keyless caches")
        occupied = other._ident != 0
        for i in np.flatnonzero(occupied):
            self._ident[i] = other._ident[i]
            self._values[i] = other._values[i]

    def clear(self):
        self._ident[:] = 0
        self._values = [None] * self.size

    def length(self):
        return int((self._ident != 0).sum())

    def max_length(self):
        return self.size


def create_cache(cache_choice: str, max_size: int) -> Optional[Cache]:
    """(ref ``general_utils.create_cache``)."""
    if cache_choice == "dict":
        return DictCache(max_size)
    if cache_choice == "keyless":
        return KeylessCache(max_size)
    if cache_choice in ("disabled", "none"):
        return None
    raise ValueError(f"bad cache_choice {cache_choice!r}")
