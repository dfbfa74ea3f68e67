"""Bounded search-history recorder: the learned-seeding dataset.

The PyTorch port's copy of the reference's `repro.obs.history`, in the
same npz format (host numpy only).

Every rounding-segment boundary of a served (or benchmarked) search
appends one row — (spec fingerprint, canonical workload, request id,
segment index, best EDP so far, and the best *rounded* mapping at that
boundary).  This is exactly the (spec, mapping, quality) trajectory
data the ROADMAP's learned start-point generator (DiffAxE / AIRCHITECT
v2 style) trains on, persisted as a first-class npz artifact.

Rows are bounded (drop-oldest past ``max_rows``, counted in
``dropped``) so a long-lived server can record forever.  Mappings are
ragged across workloads (layer count L varies), so the npz stores the
scalar columns as flat arrays plus one ``factors_<i>`` / ``orders_<i>``
array pair per row.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class HistoryRow:
    spec: str           # spec / engine-structure fingerprint
    workload: str       # canonical workload key
    request_id: str     # "" for direct (non-served) searches
    segment: int        # rounding-segment index within the search
    best_edp: float     # running best EDP at this boundary
    factors: np.ndarray  # best rounded mapping factors, (L, 2, nl, 7)
    orders: np.ndarray   # best loop orders, (L, nl)


class HistoryRecorder:
    """Append-only, bounded, npz-persistable search-history store."""

    def __init__(self, max_rows: int = 4096):
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.max_rows = max_rows
        self._rows: deque[HistoryRow] = deque()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._rows)

    def record(self, *, spec: str, workload: str, segment: int,
               best_edp: float, factors, orders,
               request_id: str = "") -> None:
        self._rows.append(HistoryRow(
            spec=str(spec), workload=str(workload),
            request_id=str(request_id), segment=int(segment),
            best_edp=float(best_edp),
            factors=np.asarray(factors, np.float32),
            orders=np.asarray(orders, np.int32)))
        while len(self._rows) > self.max_rows:
            self._rows.popleft()
            self.dropped += 1

    def rows(self, request_id: str | None = None) -> list[HistoryRow]:
        if request_id is None:
            return list(self._rows)
        return [r for r in self._rows if r.request_id == request_id]

    def save(self, path) -> int:
        """Write the store as one ``.npz``; returns the row count."""
        rows = list(self._rows)
        payload = {
            "version": np.int64(1),
            "n_rows": np.int64(len(rows)),
            "dropped": np.int64(self.dropped),
            "spec": np.array([r.spec for r in rows], dtype=np.str_),
            "workload": np.array([r.workload for r in rows],
                                 dtype=np.str_),
            "request_id": np.array([r.request_id for r in rows],
                                   dtype=np.str_),
            "segment": np.array([r.segment for r in rows], np.int64),
            "best_edp": np.array([r.best_edp for r in rows],
                                 np.float64),
        }
        for i, r in enumerate(rows):
            payload[f"factors_{i}"] = r.factors
            payload[f"orders_{i}"] = r.orders
        np.savez(path, **payload)
        return len(rows)

    @classmethod
    def load(cls, path) -> "HistoryRecorder":
        with np.load(path, allow_pickle=False) as z:
            n = int(z["n_rows"])
            rec = cls(max_rows=max(n, 1))
            rec.dropped = int(z["dropped"])
            for i in range(n):
                rec._rows.append(HistoryRow(
                    spec=str(z["spec"][i]),
                    workload=str(z["workload"][i]),
                    request_id=str(z["request_id"][i]),
                    segment=int(z["segment"][i]),
                    best_edp=float(z["best_edp"][i]),
                    factors=np.asarray(z[f"factors_{i}"]),
                    orders=np.asarray(z[f"orders_{i}"])))
        return rec
