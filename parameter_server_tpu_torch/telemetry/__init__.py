"""Unified telemetry: metrics registry + logical-clock span tracing.

Counterpart of ``parameter_server_tpu/telemetry`` with the same
modules, exports and metric catalog; only :mod:`device` is rewritten
for PyTorch and CUDA. One low-overhead spine for every layer's observability (see
``doc/OBSERVABILITY.md`` for the metric catalog and how to read it):

- :mod:`registry` — named Counter/Gauge/Histogram instruments,
  process-default registry (hung off ``Postoffice``), JSON snapshots and
  Prometheus text exposition;
- :mod:`spans` — ``span(name, ts=...)`` host intervals correlated to
  executor logical timestamps, appended to a JSONL sink; flow ids
  (``new_flow``/``flow_scope``) correlate one batch/request across
  threads;
- :mod:`timeline` — merged cross-thread timeline reader + Chrome
  trace-event / Perfetto export with flow arrows;
- :mod:`attribution` — critical-path analyzer over a timeline: per-step
  / per-request attribution to {host-prep, encode, upload, queue-wait,
  device-compute, decode, reply} and the binding resource;
- :mod:`instruments` — the canonical catalog of metric names each layer
  records (executor phases, van bytes, parameter push/pull, app volume,
  heartbeat traffic);
- :mod:`aggregate` — cluster aggregation: per-node registry exports
  merged under a ``node`` label (counters sum, gauges stay per-node,
  histograms merge bucket-wise) with per-node staleness marking;
- :mod:`exposition` — the HTTP scrape point (/metrics, /healthz,
  /debug/snapshot) over the cluster aggregate;
- :mod:`alerts` — declarative threshold/burn-rate SLO rules evaluated
  in-process on a sliding window, pending→firing→resolved state
  exported as ``ps_alert_state``; multi-window (fast+slow burn) and
  ``trend`` (drift/leak) conditions evaluate from the history plane;
- :mod:`history` — the time plane: a bounded multi-resolution ring
  cascade (1 s × 10 m → 10 s × 2 h → 60 s × 12 h) over the registry
  with typed downsampling (counters→rate deltas, gauges→last/min/max,
  histograms→bucket-delta merges), range queries, robust trend
  estimation and steady-state drift checks
  (``doc/OBSERVABILITY.md`` "History plane");
- :mod:`device` — the device truth plane: an inventory over the entry
  points that launch work on the card (per-name signatures, new shapes
  after warm-up counted as recompiles), roofline gauges from sampled
  CUDA event pairs against declared work, and device-memory accounting
  from ``torch.cuda.memory_stats``.
"""

from .aggregate import CLUSTER_NODE, ClusterAggregator
from .alerts import AlertManager, AlertRule, default_rules, load_rules
from .device import DeviceInventory, HbmMonitor, aot_analyze, instrument
from .exposition import ExpositionServer, close_cluster, expose_cluster
from .history import (
    HistoryStore,
    default_store,
    drift_check,
    installed_store,
    reset_default_store,
    set_default_store,
)

from .registry import (
    Counter,
    DuplicateMetricError,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    enabled,
    reset_default_registry,
    set_enabled,
)
from .spans import (
    JsonlSink,
    close_sink,
    current_flow,
    emit,
    flow_scope,
    get_sink,
    install_sink,
    maybe_new_flow,
    new_flow,
    parked_sink,
    span,
)

__all__ = [
    "AlertManager",
    "AlertRule",
    "CLUSTER_NODE",
    "ClusterAggregator",
    "Counter",
    "DeviceInventory",
    "DuplicateMetricError",
    "ExpositionServer",
    "Gauge",
    "HbmMonitor",
    "HistoryStore",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "aot_analyze",
    "close_cluster",
    "default_rules",
    "default_store",
    "drift_check",
    "expose_cluster",
    "installed_store",
    "reset_default_store",
    "set_default_store",
    "instrument",
    "load_rules",
    "close_sink",
    "current_flow",
    "default_registry",
    "emit",
    "enabled",
    "flow_scope",
    "get_sink",
    "install_sink",
    "maybe_new_flow",
    "new_flow",
    "parked_sink",
    "reset_default_registry",
    "set_enabled",
    "span",
]
