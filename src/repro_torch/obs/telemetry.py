"""Structured spans + a metrics registry for the PyTorch port.

The port's copy of the reference's `repro.obs.telemetry`: the same
tracer, span trees, metrics registry, Prometheus text and engine-build
hooks, so the port's engines and serving stack record the same span
names and metric families.

Design constraints, in order:

* **One injected clock.**  Engine and serving code never read a clock;
  they receive time through a `Tracer`, whose clock is injected at
  construction, or through the module-level `default_clock`, a
  reference to `time.monotonic` (never a call written here), which
  `set_default_clock` swaps for a fake in tests.  The serving layer
  passes its own ``ServiceConfig.clock_fn``.
* **A true no-op mode.**  The disabled tracer returns a shared,
  stateless context manager: no allocation, no lock.
* **Thread-safe.**  The HTTP front-end serves ``/v1/metrics`` and
  ``/v1/trace/<rid>`` from handler threads while the scheduler thread
  writes spans; all shared state is behind one lock per object, and
  span parenting uses a per-thread stack (plus explicit ``parent_id``
  for request lifecycles that cross scheduler steps).

Spans export as JSONL (one span per line) or as a Chrome-trace /
Perfetto ``traceEvents`` JSON; metrics render in the Prometheus text
exposition format.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

# Monotonic seconds: the one clock of the port's telemetry.  Held as a
# reference, so no module outside this one reads the clock itself.
default_clock: Callable[[], float] = time.monotonic


def set_default_clock(clock: Callable[[], float]) -> Callable[[], float]:
    """Swap the module clock (tests inject a fake); returns the
    previous one.  Tracers built afterwards without a clock, and the
    engine-build hooks, read the new one."""
    global default_clock
    prev = default_clock
    default_clock = clock
    return prev


# ---------------------------------------------------------------- spans

@dataclass
class Span:
    span_id: int
    parent_id: Optional[int]
    name: str
    t_start: float
    t_end: Optional[float] = None
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)  # [(t, name, attrs)]

    @property
    def duration_s(self) -> float:
        return (self.t_end - self.t_start) if self.t_end is not None \
            else 0.0

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t_start": self.t_start,
                "t_end": self.t_end, "duration_s": self.duration_s,
                "attrs": dict(self.attrs),
                "events": [{"t": t, "name": n, "attrs": dict(a)}
                           for t, n, a in self.events]}


class _NoopSpan:
    """Shared, stateless disabled-mode span: reentrant and reusable."""
    __slots__ = ()
    span_id = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name: str, **attrs) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    """Context manager + handle for one span of an enabled tracer."""
    __slots__ = ("_tracer", "span_id")

    def __init__(self, tracer: "Tracer", span_id: int):
        self._tracer = tracer
        self.span_id = span_id

    def __enter__(self):
        self._tracer._push(self.span_id)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._pop(self.span_id)
        attrs = {"error": repr(exc)} if exc is not None else {}
        self._tracer.end_span(self.span_id, **attrs)
        return False

    def event(self, name: str, **attrs) -> None:
        self._tracer.add_event(self.span_id, name, **attrs)

    def set(self, **attrs) -> None:
        self._tracer.set_attrs(self.span_id, **attrs)


class Tracer:
    """Thread-safe structured-span recorder with an injected clock.

    ``with tracer.span("engine.build", kind="fused"): ...`` nests via a
    per-thread stack; lifecycles that outlive one call frame use
    ``start_span``/``end_span`` with explicit ``parent_id``.  Bounded:
    the oldest *finished* root trees are dropped past ``max_spans``
    (counted in ``dropped``).
    """

    def __init__(self, clock: Callable[[], float] | None = None,
                 enabled: bool = True, max_spans: int = 100_000):
        self.enabled = enabled
        self._clock = clock if clock is not None else default_clock
        self._lock = threading.Lock()
        self._spans: dict[int, Span] = {}
        self._order: list[int] = []
        self._next_id = 1
        self._tls = threading.local()
        self.max_spans = max_spans
        self.dropped = 0

    # -- per-thread parenting stack
    def _stack(self) -> list[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span_id: int) -> None:
        self._stack().append(span_id)

    def _pop(self, span_id: int) -> None:
        st = self._stack()
        if st and st[-1] == span_id:
            st.pop()

    def current_span_id(self) -> Optional[int]:
        st = self._stack()
        return st[-1] if st else None

    # -- span lifecycle
    def span(self, name: str, parent_id: Optional[int] = None, **attrs):
        """Context manager for a lexically-scoped span."""
        if not self.enabled:
            return _NOOP_SPAN
        sid = self.start_span(name, parent_id=parent_id, **attrs)
        return _LiveSpan(self, sid)

    def start_span(self, name: str, parent_id: Optional[int] = None,
                   **attrs) -> int:
        """Open a span explicitly (caller must ``end_span`` it).
        Returns -1 when disabled."""
        if not self.enabled:
            return -1
        if parent_id is None:
            parent_id = self.current_span_id()
        now = self._clock()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._spans[sid] = Span(sid, parent_id, name, now,
                                    attrs=dict(attrs))
            self._order.append(sid)
            self._evict_locked()
        return sid

    def end_span(self, span_id: int, **attrs) -> None:
        if not self.enabled or span_id < 0:
            return
        now = self._clock()
        with self._lock:
            sp = self._spans.get(span_id)
            if sp is not None and sp.t_end is None:
                sp.t_end = now
                if attrs:
                    sp.attrs.update(attrs)

    def add_event(self, span_id: int, name: str, **attrs) -> None:
        if not self.enabled or span_id < 0:
            return
        now = self._clock()
        with self._lock:
            sp = self._spans.get(span_id)
            if sp is not None:
                sp.events.append((now, name, dict(attrs)))

    def event(self, name: str, **attrs) -> None:
        """Attach an event to the innermost open span of this thread."""
        sid = self.current_span_id() if self.enabled else None
        if sid is not None:
            self.add_event(sid, name, **attrs)

    def set_attrs(self, span_id: int, **attrs) -> None:
        if not self.enabled or span_id < 0:
            return
        with self._lock:
            sp = self._spans.get(span_id)
            if sp is not None:
                sp.attrs.update(attrs)

    def _evict_locked(self) -> None:
        # Drop oldest finished spans past the bound; open spans (live
        # request roots) are never dropped.
        while len(self._order) > self.max_spans:
            for i, sid in enumerate(self._order):
                sp = self._spans.get(sid)
                if sp is None or sp.t_end is not None:
                    del self._order[i]
                    self._spans.pop(sid, None)
                    self.dropped += 1
                    break
            else:
                break  # everything still open — refuse to drop

    # -- queries / export
    def spans(self) -> list[Span]:
        with self._lock:
            return [self._spans[s] for s in self._order
                    if s in self._spans]

    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.spans() if s.name == name]

    def total_s(self, name: str) -> float:
        """Summed duration of all finished spans with this name."""
        return sum(s.duration_s for s in self.spans_named(name)
                   if s.t_end is not None)

    def tree(self, root_id: int) -> Optional[dict]:
        """Nested ``{span..., "children": [...]}`` dict rooted at
        ``root_id``, children in start order; None if unknown."""
        with self._lock:
            if root_id not in self._spans:
                return None
            kids: dict[int, list[int]] = {}
            for sid in self._order:
                sp = self._spans.get(sid)
                if sp is not None and sp.parent_id is not None:
                    kids.setdefault(sp.parent_id, []).append(sid)

            def build(sid: int) -> dict:
                d = self._spans[sid].to_dict()
                d["children"] = [build(c) for c in kids.get(sid, ())
                                 if c in self._spans]
                return d

            return build(root_id)

    def export_jsonl(self, path) -> int:
        """One span JSON object per line; returns the span count."""
        snap = [s.to_dict() for s in self.spans()]
        with open(path, "w") as f:
            for d in snap:
                f.write(json.dumps(d) + "\n")
        return len(snap)

    def chrome_trace(self) -> dict:
        """Chrome-trace / Perfetto ``traceEvents`` JSON (complete "X"
        events, microsecond timestamps, span events as instants)."""
        events = []
        for sp in self.spans():
            if sp.t_end is None:
                continue
            events.append({
                "name": sp.name, "ph": "X", "pid": 1,
                "tid": sp.parent_id or 0,
                "ts": sp.t_start * 1e6,
                "dur": sp.duration_s * 1e6,
                "args": {**sp.attrs, "span_id": sp.span_id},
            })
            for t, name, attrs in sp.events:
                events.append({"name": name, "ph": "i", "pid": 1,
                               "tid": sp.parent_id or 0, "ts": t * 1e6,
                               "s": "t", "args": dict(attrs)})
        return {"traceEvents": events,
                "displayTimeUnit": "ms"}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._order.clear()
            self.dropped = 0


# -------------------------------------------------------------- metrics

def log_buckets(lo: float = 1e-4, hi: float = 100.0,
                per_decade: int = 2) -> tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds in ``[lo, hi]``."""
    out, v, step = [], lo, 10.0 ** (1.0 / per_decade)
    while v <= hi * 1.0000001:
        out.append(v)
        v *= step
    return tuple(out)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_str(self, key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter inc must be >= 0")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._label_str(k)} {v}"
                for k, v in items] or [f"{self.name} 0"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{self._label_str(k)} {v}"
                for k, v in items] or [f"{self.name} 0"]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: tuple[float, ...] | None = None):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(buckets) if buckets else log_buckets()
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"{self.name}: buckets must be sorted")
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = {}
        self._n: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            i = len(self.buckets)
            for j, ub in enumerate(self.buckets):
                if value <= ub:
                    i = j
                    break
            counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + float(value)
            self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._n.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sum.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        with self._lock:
            keys = sorted(self._counts)
            snap = {k: (list(self._counts[k]), self._sum[k], self._n[k])
                    for k in keys}
        lines = []
        inf_le = 'le="+Inf"'
        for key, (counts, total, n) in snap.items():
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                le = f'le="{ub:g}"'
                lines.append(f"{self.name}_bucket"
                             f"{self._label_str(key, le)} {cum}")
            lines.append(f"{self.name}_bucket"
                         f"{self._label_str(key, inf_le)} {n}")
            lines.append(f"{self.name}_sum{self._label_str(key)} "
                         f"{total}")
            lines.append(f"{self.name}_count{self._label_str(key)} {n}")
        if not snap:
            lines.append(f'{self.name}_bucket{{le="+Inf"}} 0')
            lines.append(f"{self.name}_sum 0")
            lines.append(f"{self.name}_count 0")
        return lines


class MetricsRegistry:
    """Get-or-create registry of named metrics, rendered as Prometheus
    text.  Re-registration with the same name returns the existing
    metric (type-checked), so module-level hooks stay idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, requested {cls.kind}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def to_prometheus(self) -> str:
        lines = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly {name: total or per-label dict} snapshot."""
        out = {}
        for m in self.metrics():
            if isinstance(m, Counter):
                out[m.name] = m.total()
            elif isinstance(m, Gauge):
                with m._lock:
                    vals = dict(m._values)
                out[m.name] = (vals.get((), 0.0) if not m.labelnames
                               else {",".join(k): v
                                     for k, v in vals.items()})
            elif isinstance(m, Histogram):
                with m._lock:
                    out[m.name] = {"count": sum(m._n.values()),
                                   "sum": sum(m._sum.values())}
        return out


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Concatenate several registries into one exposition body (the
    server merges its service registry with the global engine one)."""
    return "".join(r.to_prometheus() for r in registries)


# -------------------------------------------------- engine-build hook

def start_build(*, kind: str, cache: str, label: str = ""):
    """Open an ``engine.build`` span for a cache-miss build whose body
    isn't a single closure (returns an opaque token for
    `finish_build`)."""
    tracer = get_tracer()
    sid = tracer.start_span("engine.build", kind=kind, cache=cache,
                            label=label)
    return (sid, default_clock(), kind, cache)


def finish_build(token) -> float:
    """Close a `start_build` span; records latency into the global
    registry and returns the build seconds."""
    sid, t0, kind, cache = token
    dt = default_clock() - t0
    get_tracer().end_span(sid, build_s=dt)
    # Metric names and help texts are the reference's, so the two
    # packages' exposition texts are equal.
    m = get_metrics()
    m.counter("engine_build_total",
              "compiled-engine cache misses that built a program",
              ("cache", "kind")).inc(cache=cache, kind=kind)
    m.histogram("engine_build_seconds",
                "engine build (trace construction + jit setup) latency",
                ("cache",)).observe(dt, cache=cache)
    return dt


def profile_build(build: Callable, *, kind: str, cache: str,
                  label: str = ""):
    """Run an engine-cache miss ``build()`` under an ``engine.build``
    span and record its latency into the global registry.  Returns
    ``(value, seconds)`` so the cache can keep per-entry build times
    (`LRUCache.note_build_time`).  Timing comes from this module's
    clock, keeping the calling engine code OB601-clean."""
    token = start_build(kind=kind, cache=cache, label=label)
    value = build()
    dt = finish_build(token)
    return value, dt


# ------------------------------------------------------------- globals

_GLOBAL_TRACER = Tracer(enabled=False)
_GLOBAL_METRICS = MetricsRegistry()


def get_tracer() -> Tracer:
    """The process-wide tracer engine hooks report to.  Disabled (true
    no-op) by default; benchmarks and the server enable/replace it."""
    return _GLOBAL_TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (returns the previous one)."""
    global _GLOBAL_TRACER
    prev = _GLOBAL_TRACER
    _GLOBAL_TRACER = tracer
    return prev


def get_metrics() -> MetricsRegistry:
    """The process-wide registry (engine cache / checkpoint metrics)."""
    return _GLOBAL_METRICS
