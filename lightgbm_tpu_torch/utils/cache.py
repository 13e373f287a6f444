"""A small instrumented LRU, for per-shape derived objects.

A copy of ``LRUCache`` from ``lightgbm_tpu/utils/cache.py:13`` (the port
imports nothing of the JAX package). ``Booster._stacked_forests`` keeps
the stacked forests of its recent tree slices in one.
"""
from collections import OrderedDict


class LRUCache:
    """Bounded mapping with least-recently-used eviction and hit/miss
    counters (the counters feed capacity tuning: a hot cache with a high
    miss rate wants a bigger capacity, one with zero hits wants deleting).

    ``capacity=0`` disables storage entirely — every get is a miss, every
    put a no-op — so callers can hard-off a cache from config without
    branching at each call site. Keys must be hashable.
    """

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._data = OrderedDict()

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def get(self, key, default=None):
        """Value for ``key`` (refreshing its recency), else ``default``."""
        try:
            value = self._data[key]
        except KeyError:
            self.misses += 1
            return default
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        """Insert/overwrite ``key``, evicting the LRU entry past capacity."""
        if self.capacity == 0:
            return
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def keys(self):
        """Keys in eviction order: least-recently-used first."""
        return list(self._data.keys())

    def clear(self) -> None:
        self._data.clear()

    def stats(self) -> dict:
        return {"size": len(self._data), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses}
