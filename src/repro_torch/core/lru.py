"""Bounded LRU cache with hit/miss/eviction accounting.

The engine caches (`search._ENGINE_CACHE`, `fleet._FLEET_ENGINE_CACHE`)
hold per-(workload, config, device) engines: loss closures plus their
static tables already placed on the device.  They must stay warm
across repeated searches, but a long-lived co-search server streams an
unbounded variety of (workload, config) shapes through them, so the
cache is also
*bounded* and observable: recently-used entries survive (true LRU, not
insertion order), and hit/miss/eviction counters report its health.
The PyTorch port's copy of the reference's `repro.core.lru`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable


class LRUCache:
    """A bounded least-recently-used cache with stats counters."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Per-entry build latency (label -> seconds), fed by the
        # engine.build telemetry spans via `note_build_time` — the cache
        # itself never reads a clock (ND202/OB601).  Bounded separately
        # from the data so evicted-then-rebuilt entries keep history.
        self._build_s: OrderedDict = OrderedDict()
        self.build_count = 0
        self.build_seconds_total = 0.0
        # Fresh inserts per key (bounded like `_build_s`): an engine
        # cache's counterpart of a jit cache's program count, read by
        # `analysis.contracts.compiled_programs`.
        self._inserts: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key, default=None):
        """Look up `key`, refreshing its recency.  Counts a hit or miss."""
        if key in self._data:
            self.hits += 1
            self._data.move_to_end(key)
            return self._data[key]
        self.misses += 1
        return default

    def put(self, key, value) -> None:
        """Insert `key`, evicting the least-recently-used entry at the
        bound (counted in `evictions`)."""
        if key in self._data:
            self._data.move_to_end(key)
        else:
            if len(self._data) >= self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1
            self._inserts[key] = self._inserts.pop(key, 0) + 1
            while len(self._inserts) > 4 * self.maxsize:
                self._inserts.popitem(last=False)
        self._data[key] = value

    def get_or_build(self, key, build: Callable):
        """The engine-cache idiom: return the cached value (hit) or
        build, insert and return it (miss + possible eviction)."""
        hit = self.get(key, None)
        if hit is None:
            hit = build()
            self.put(key, hit)
        return hit

    def pop_lru(self):
        """Remove and return the least-recently-used ``(key, value)``
        pair (counted as an eviction), or ``None`` when empty.  The
        checkpoint garbage collector uses this to sweep the oldest task
        directories first."""
        if not self._data:
            return None
        item = self._data.popitem(last=False)
        self.evictions += 1
        return item

    def discard(self, key) -> None:
        """Drop `key` if present, without stats side effects — for
        entries whose backing resource was deleted out of band."""
        self._data.pop(key, None)

    def inserts_of(self, key) -> int:
        """How many times `key` was inserted fresh: once per build of an
        engine cache's entry, more after an eviction or a `clear`."""
        return self._inserts.get(key, 0)

    def key_of(self, value):
        """The key whose cached value *is* `value` (identity), or
        ``None``."""
        for k, v in self._data.items():
            if v is value:
                return k
        return None

    def keys(self):
        """Keys in LRU-to-MRU order (a snapshot list, safe to mutate
        the cache while iterating)."""
        return list(self._data.keys())

    def note_build_time(self, label: str, seconds: float) -> None:
        """Record one entry build's latency under a human-readable
        label (timed by the caller's telemetry span).  Labels are
        bounded at ``4 * maxsize`` (oldest dropped) so a long-lived
        server can't grow this without limit."""
        self._build_s[label] = float(seconds)
        self._build_s.move_to_end(label)
        while len(self._build_s) > 4 * self.maxsize:
            self._build_s.popitem(last=False)
        self.build_count += 1
        self.build_seconds_total += float(seconds)

    def clear(self, reset_stats: bool = False) -> None:
        self._data.clear()
        if reset_stats:
            self.hits = self.misses = self.evictions = 0
            self._build_s.clear()
            self._inserts.clear()
            self.build_count = 0
            self.build_seconds_total = 0.0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"size": len(self._data), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "build_count": self.build_count,
                "build_seconds_total": self.build_seconds_total,
                "build_seconds": dict(self._build_s)}
