"""Observability spine of the PyTorch port: structured spans, metrics,
search history.

One tracer/metrics layer shared by the fused engine, the fleet and the
serving stack (`telemetry`), plus the npz-backed search-history store
(`history`), each a copy of the reference's `repro.obs` module.
"""
from .telemetry import (  # noqa: F401
    MetricsRegistry,
    Tracer,
    default_clock,
    get_metrics,
    get_tracer,
    render_prometheus,
    set_default_clock,
    set_tracer,
)
from .history import HistoryRecorder  # noqa: F401
