"""Cache subsystem + native xxhash tests."""

import numpy as np
import pytest

from nuzero.native import load, xxh64, xxh64_batch
from nuzero.utils.caches import DictCache, KeylessCache, create_cache


def test_xxh64_known_vectors():
    """Official xxHash64 test vectors (seed 0)."""
    if load() is None:
        pytest.skip("native toolchain unavailable")
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert xxh64(b"abc") == 0x44BC2CF5AD770999


def test_xxh64_batch_matches_single():
    rows = np.random.default_rng(0).integers(0, 255, (16, 64), np.uint8)
    batch = xxh64_batch(rows)
    for i in range(16):
        assert batch[i] == np.uint64(xxh64(rows[i].tobytes()))


@pytest.mark.parametrize("cls", [DictCache, KeylessCache])
def test_cache_roundtrip(cls):
    cache = cls(64)
    s = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert cache.get(s) is None
    cache.put((s, ("policy", 0.5)))
    assert cache.get(s) == ("policy", 0.5)
    assert cache.hits == 1 and cache.misses == 1
    assert cache.length() == 1


def test_keyless_no_keys_stored():
    cache = KeylessCache(64)
    assert cache.size == 64  # power-of-2 sizing
    s1 = np.ones((2, 2), np.float32)
    s2 = np.zeros((2, 2), np.float32)
    cache.put((s1, "a"))
    cache.put((s2, "b"))
    assert cache.get(s1) == "a"
    assert cache.get(s2) == "b"


def test_keyless_merge():
    a, b = KeylessCache(32), KeylessCache(32)
    s = np.full((2,), 3.0, np.float32)
    b.put((s, "v"))
    a.update(b)
    assert a.get(s) == "v"


def test_dict_cache_eviction():
    cache = DictCache(10)
    for i in range(12):
        cache.put((np.full(4, i, np.float32), i))
    assert cache.length() <= 10


def test_factory():
    assert isinstance(create_cache("dict", 10), DictCache)
    assert isinstance(create_cache("keyless", 10), KeylessCache)
    assert create_cache("disabled", 10) is None
    with pytest.raises(ValueError):
        create_cache("bogus", 10)
