"""Canonical metric catalog — the ONE place metric names are declared.

Instrumentation call sites fetch their instruments through these
accessors (idempotent ``ensure_*``: per-instance components — every
Executor, every parameter store — share the process-wide series and
distinguish themselves by label). ``install_all`` instantiates every
family against a registry; ``script/metrics_lint.py`` runs it on a fresh
registry to fail the build on duplicate or non-snake_case names, and
``doc/OBSERVABILITY.md`` documents the same names.
"""

from __future__ import annotations

from typing import Dict

from .registry import Counter, Gauge, Histogram, MetricsRegistry

# fine low-end buckets for host dispatch phases (queue-wait on an idle
# executor is single-digit microseconds)
PHASE_BUCKETS = (
    1e-6, 1e-5, 1e-4, 3.2e-4, 1e-3, 3.2e-3, 1e-2, 3.2e-2,
    1e-1, 3.2e-1, 1.0, 3.2, 10.0, 32.0, 100.0,
)


def executor_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Per-step executor phases + depth gauges (labeled by executor)."""
    return {
        "queue_wait": reg.ensure_histogram(
            "executor_queue_wait_seconds",
            "submit to dispatch-thread pickup, per step",
            labelnames=("executor",),
            buckets=PHASE_BUCKETS,
        ),
        "run": reg.ensure_histogram(
            "executor_run_seconds",
            "step body wall time on the dispatch thread (XLA dispatch, "
            "not device completion)",
            labelnames=("executor",),
            buckets=PHASE_BUCKETS,
        ),
        "materialize": reg.ensure_histogram(
            "executor_materialize_seconds",
            "block_until_ready wall time when the step's futures were "
            "forced (0 when nothing blocked)",
            labelnames=("executor",),
            buckets=PHASE_BUCKETS,
        ),
        "total": reg.ensure_histogram(
            "executor_step_total_seconds",
            "submit to finished (materialized), per step",
            labelnames=("executor",),
            buckets=PHASE_BUCKETS,
        ),
        "steps": reg.ensure_counter(
            "executor_steps_finished_total",
            "steps finished (ran + materialized)",
            labelnames=("executor",),
        ),
        "in_flight": reg.ensure_gauge(
            "executor_in_flight",
            "started (dispatched) but unfinished steps",
            labelnames=("executor",),
        ),
        "pending": reg.ensure_gauge(
            "executor_pending",
            "submitted steps not yet picked by the dispatch thread",
            labelnames=("executor",),
        ),
    }


def van_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Transport-layer byte counters (ref van.cc send_bytes_/recv_bytes_)."""
    return {
        "placed_bytes": reg.ensure_counter(
            "van_placed_bytes_total",
            "host arrays placed onto the device mesh (put_*)",
        ),
        "wire_sent_bytes": reg.ensure_counter(
            "van_wire_sent_bytes_total",
            "serialized frames leaving through transfer(), sender side",
        ),
        "wire_recv_bytes": reg.ensure_counter(
            "van_wire_recv_bytes_total",
            "serialized frames decoded by from_wire(), receiver side",
        ),
        "transfers": reg.ensure_counter(
            "van_transfers_total",
            "host wire transfers (request or response frames)",
        ),
    }


def parameter_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Push/Pull latency + key volume per store/channel (parameter layer)."""
    return {
        "push_latency": reg.ensure_histogram(
            "ps_push_latency_seconds",
            "push submit to finished, per request",
            labelnames=("store", "channel"),
        ),
        "pull_latency": reg.ensure_histogram(
            "ps_pull_latency_seconds",
            "pull submit to finished, per request",
            labelnames=("store", "channel"),
        ),
        "push_pull_latency": reg.ensure_histogram(
            "ps_push_pull_latency_seconds",
            "fused push_pull submit to finished, per request",
            labelnames=("store", "channel"),
        ),
        "push_keys": reg.ensure_counter(
            "ps_push_keys_total",
            "keys carried by push requests",
            labelnames=("store", "channel"),
        ),
        "pull_keys": reg.ensure_counter(
            "ps_pull_keys_total",
            "keys carried by pull requests",
            labelnames=("store", "channel"),
        ),
        "push_pull_keys": reg.ensure_counter(
            "ps_push_pull_keys_total",
            "keys carried by fused push_pull requests",
            labelnames=("store", "channel"),
        ),
    }


def kvops_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Device data-plane counters (ops/kv_ops + KeyDirectory slot cache).

    The donated-push counter and the fused-dispatch histogram size the
    zero-copy wins (doc/PERFORMANCE.md "Donation rules"); the slot-cache
    pair is the device analog of the reference's key-caching filter hit
    rate (src/filter/key_caching.h)."""
    return {
        "donated_pushes": reg.ensure_counter(
            "ps_kvops_donated_pushes_total",
            "table updates dispatched through a donated (in-place) "
            "push/push_pull — each one avoids a full [P, k] HBM copy",
        ),
        "fused_dispatch": reg.ensure_histogram(
            "ps_kvops_fused_dispatch_seconds",
            "host-side dispatch wall time of fused push_pull programs "
            "(one launch instead of a push + a pull)",
            buckets=PHASE_BUCKETS,
        ),
        "slot_cache_hits": reg.ensure_counter(
            "ps_directory_slot_cache_hits_total",
            "KeyDirectory.slots calls answered from the signature cache "
            "(hash/searchsorted and the device index upload skipped)",
        ),
        "slot_cache_misses": reg.ensure_counter(
            "ps_directory_slot_cache_misses_total",
            "KeyDirectory.slots calls that computed the slot mapping",
        ),
    }


#: stage labels the ingest pipeline records (doc/OBSERVABILITY.md):
#: read (source next/parse), filter (countmin tail-filter), prep
#: (localize/pack in the worker pool), upload (host→device staging)
INGEST_STAGES = ("read", "filter", "prep", "upload")


def ingest_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Host-ingest pipeline: per-stage latency, queue depth, volume.

    The ingest plane is the host-side bottleneck (the device step is
    ~100x faster than the host→device transfer): these size where a
    training run's host seconds go — parse vs filter vs prep vs upload
    — and how full the pipeline's bounded queues run (a persistently
    empty queue means the stage upstream of it is the bottleneck)."""
    return {
        "stage_seconds": reg.ensure_histogram(
            "ps_ingest_stage_seconds",
            "per-minibatch wall time inside one ingest stage "
            "(read/filter/prep/upload)",
            labelnames=("stage",),
            buckets=PHASE_BUCKETS,
        ),
        "queue_depth": reg.ensure_gauge(
            "ps_ingest_queue_depth",
            "batches staged ahead of the consumer in an ingest queue, "
            "sampled at each emission",
            labelnames=("queue",),
        ),
        "examples": reg.ensure_counter(
            "ps_ingest_examples_total",
            "examples emitted by one ingest pipeline stage (host-side "
            "count, before device confirmation); chained pipelines — a "
            "reader feeding a train ingest — report each hop under its "
            "own label",
            labelnames=("pipeline",),
        ),
        "batches": reg.ensure_counter(
            "ps_ingest_batches_total",
            "minibatches emitted by one ingest pipeline stage",
            labelnames=("pipeline",),
        ),
        "uploaded_bytes": reg.ensure_counter(
            "ps_ingest_uploaded_bytes_total",
            "host bytes staged onto the device mesh by the ingest "
            "uploader (double-buffered device_put)",
        ),
    }


def wire_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Compact host→device wire (learner/wire.py): encoded bytes per
    encoding, bytes the encodings and the upload key cache kept off the
    link, encode cost, and cache traffic. The link-bound ceiling is
    bytes/example × link MB/s — these counters are its numerator."""
    return {
        "bytes": reg.ensure_counter(
            "ps_wire_bytes_total",
            "host bytes actually shipped (or queued to ship) on the "
            "host→device wire, by encoding mode",
            labelnames=("encoding",),
        ),
        "saved_bytes": reg.ensure_counter(
            "ps_wire_saved_bytes_total",
            "bytes kept OFF the wire vs the raw batch buffers — "
            "reason=encoding (compact formats) or cache_hit (a repeated "
            "array re-used its device-resident buffer)",
            labelnames=("reason",),
        ),
        "encode_seconds": reg.ensure_histogram(
            "ps_wire_encode_seconds",
            "per-batch wall time of the host-side wire encode (a "
            "stateless prep-pool stage — off the trainer thread)",
            buckets=PHASE_BUCKETS,
        ),
        "cache_hits": reg.ensure_counter(
            "ps_wire_cache_hits_total",
            "upload key-cache hits (crc32c signature routed, exact "
            "compare verified)",
        ),
        "cache_misses": reg.ensure_counter(
            "ps_wire_cache_misses_total",
            "upload key-cache misses (array uploaded and retained)",
        ),
        "fallbacks": reg.ensure_counter(
            "ps_wire_fallback_total",
            "batches an encoder refused (domain verify failed — ragged "
            "rows, non-sign labels, pinned-statics overflow, ...) and "
            "shipped on the raw wire instead, by reason; the "
            "verify-or-raw contract's visibility half",
            labelnames=("reason",),
        ),
    }


def serve_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Serving plane (serving/ — the request-path frontend): request
    volume + completion latency per kind, shed accounting by reason,
    the coalescer's merge economics, and read-replica traffic. The SLO
    view is ``ps_serve_latency_seconds`` p99 against
    ``ps_serve_shed_total`` — bounded tails are BOUGHT with explicit
    sheds (doc/SERVING.md, "Admission control")."""
    return {
        "requests": reg.ensure_counter(
            "ps_serve_requests_total",
            "requests admitted through the serving door, by kind "
            "(pull/predict/decode)",
            labelnames=("kind",),
        ),
        "shed": reg.ensure_counter(
            "ps_serve_shed_total",
            "requests rejected at admission (429-style), by reason: "
            "rate (token bucket empty) or queue (backlog past the "
            "depth bound)",
            labelnames=("reason",),
        ),
        "latency": reg.ensure_histogram(
            "ps_serve_latency_seconds",
            "request latency submit to completion, by kind — the "
            "serving SLO number (open-loop p50/p99 in bench records)",
            labelnames=("kind",),
            buckets=PHASE_BUCKETS,
        ),
        "queue_depth": reg.ensure_gauge(
            "ps_serve_queue_depth",
            "admitted, uncompleted requests (queued + executing), "
            "sampled at each admission",
        ),
        "coalesce_submits": reg.ensure_counter(
            "ps_serve_coalesce_submits_total",
            "merged pull windows flushed as ONE executor submit",
        ),
        "coalesce_merged_requests": reg.ensure_counter(
            "ps_serve_coalesce_merged_requests_total",
            "client pull requests carried by coalesced submits "
            "(merged/submits = the merge factor)",
        ),
        "coalesce_union_keys": reg.ensure_counter(
            "ps_serve_coalesce_union_keys_total",
            "deduped union keys actually pulled by coalesced submits "
            "(compare ps_pull_keys_total for the key dedup win)",
        ),
        "replica_hits": reg.ensure_counter(
            "ps_serve_replica_hits_total",
            "keys served from the read replica (no live-table touch)",
        ),
        "replica_misses": reg.ensure_counter(
            "ps_serve_replica_misses_total",
            "keys outside the hot-key replica, fallen through to a "
            "coalesced live pull",
        ),
        "replica_refresh": reg.ensure_histogram(
            "ps_serve_replica_refresh_seconds",
            "read-replica refresh wall time (the one serialization "
            "point with training pushes — off the request path)",
            buckets=PHASE_BUCKETS,
        ),
        "decode_tokens": reg.ensure_counter(
            "ps_serve_decode_tokens_total",
            "tokens generated by served decode requests "
            "(rows x steps, host-side count)",
        ),
        "batch_occupancy": reg.ensure_gauge(
            "ps_serve_batch_occupancy",
            "decode sessions resident in the continuous batch, sampled "
            "at every join and round boundary (occupancy/slots is the "
            "chip-fill ratio the batcher exists to raise)",
        ),
        "batch_joins": reg.ensure_counter(
            "ps_serve_batch_joins_total",
            "decode sessions joined into free batch slots at round "
            "boundaries (one per prompt row, not per request)",
        ),
        "batch_leaves": reg.ensure_counter(
            "ps_serve_batch_leaves_total",
            "batch slots released between rounds (EOS or token-budget "
            "retirement) — join/leave churn without stalling residents",
        ),
        "batch_rounds": reg.ensure_counter(
            "ps_serve_batch_rounds_total",
            "speculative rounds stepped over the shared batch (one "
            "target verify pass serves every resident session)",
        ),
        "batch_retired": reg.ensure_counter(
            "ps_serve_batch_retired_total",
            "decode sessions retired complete (their token stream is "
            "pinned identical to a sequential speculative run)",
        ),
        "degraded": reg.ensure_counter(
            "ps_serve_degraded_total",
            "requests that hit the degraded path after the live store "
            "failed or missed its deadline (503-style, DISTINCT from "
            "the admission 429s in ps_serve_shed_total): "
            "outcome=served (answered from the stale read replica "
            "inside the staleness bound) or outcome=error (DegradedError "
            "— no replica, too stale, or keys it cannot cover)",
            labelnames=("outcome",),
        ),
    }


#: update-path labels the FTRL dispatch records (ops/ftrl_sparse.py
#: resolve_update_path): pallas_sparse (fused sparse kernel),
#: xla_rows (gather→apply→scatter rows path), pallas_dense
#: (whole-shard Pallas sweep), ref (jnp/XLA dense reference)
FTRL_PATHS = ("pallas_sparse", "xla_rows", "pallas_dense", "ref")


def ftrl_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """FTRL update-path accounting (ops/ftrl.py + ops/ftrl_sparse.py).

    The path decision is STATIC per compiled step (a trace-time
    predicate — ``use_ref_path`` / ``use_sparse_kernel``), so these
    counters are incremented on the HOST at submit time (jit-purity:
    an in-kernel counter would fire once at trace and never again);
    they say which update formulation the training traffic actually
    rode, next to the ``ftrl_sparse`` A/B in bench records."""
    return {
        "rows": reg.ensure_counter(
            "ps_ftrl_rows_total",
            "state rows moved per submitted FTRL ministep — the "
            "deduped gather width (sparse formulations) or the "
            "whole-shard sweep width (dense)",
        ),
        "path": reg.ensure_counter(
            "ps_ftrl_update_path_total",
            "FTRL ministeps dispatched, by resolved update path "
            "(pallas_sparse / xla_rows / pallas_dense / ref)",
            labelnames=("path",),
        ),
    }


def device_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Device truth plane (telemetry/device.py): per-jit compile and
    recompile counts from the compiled-function inventory, the runtime
    donation-aliasing verifier, live roofline gauges (achieved GB/s /
    TFLOP/s and frac-of-peak against the benchmarks peak tables), and
    HBM/live-buffer accounting sampled by a registry collector. The
    ``fn`` label is the inventory name the wrap point declared
    (kv_push, step_encoded_scan.snap_donate, ...); ``resource`` is
    hbm or flops. A recompile RATE above noise is a storm (shape churn
    re-tracing every step — the configs/alerts/default.json rule); a
    donation fallback means XLA silently turned an in-place update
    into a whole-table copy (doc/PERFORMANCE.md "Donation rules")."""
    return {
        "compiles": reg.ensure_counter(
            "ps_device_compiles_total",
            "XLA compiles owned by the device inventory, per named "
            "function (first compile + every re-specialization)",
            labelnames=("fn",),
        ),
        "recompiles": reg.ensure_counter(
            "ps_device_recompiles_total",
            "compiles BEYOND a function's first — new avals or statics "
            "re-specialized an already-compiled entry point (zero on a "
            "healthy steady-state run after warmup)",
            labelnames=("fn",),
        ),
        "donation_fallbacks": reg.ensure_counter(
            "ps_device_donation_fallbacks_total",
            "compiles where a declared donation did not fully alias "
            "input to output (memory_analysis alias bytes below the "
            "donated argument bytes, or XLA's donated-buffers-unusable "
            "warning) — the update silently paid a copy",
            labelnames=("fn",),
        ),
        "dispatch_fallbacks": reg.ensure_counter(
            "ps_device_dispatch_fallbacks_total",
            "instrumented calls routed to the plain jit path (signature "
            "unreadable, or the compiled executable rejected the args) "
            "— correctness preserved, chip accounting skipped",
            labelnames=("fn",),
        ),
        "kernel_gb_s": reg.ensure_gauge(
            "ps_device_kernel_gb_s",
            "achieved HBM GB/s of the last sampled dispatch "
            "(cost-analysis bytes / measured wall time)",
            labelnames=("fn",),
        ),
        "kernel_tflops": reg.ensure_gauge(
            "ps_device_kernel_tflops",
            "achieved TFLOP/s of the last sampled dispatch "
            "(cost-analysis FLOPs / measured wall time)",
            labelnames=("fn",),
        ),
        "roofline_frac": reg.ensure_gauge(
            "ps_device_roofline_frac",
            "achieved fraction of this chip's peak for one resource "
            "(hbm: of HBM_PEAK_GB_S; flops: MFU vs FLOPS_PEAK_TFLOPS); "
            "absent on device kinds the peak tables do not know",
            labelnames=("fn", "resource"),
        ),
        "hbm_bytes_in_use": reg.ensure_gauge(
            "ps_device_hbm_bytes_in_use",
            "allocator bytes in use on the device at last collection "
            "(memory_stats; TPU backends)",
            labelnames=("device",),
        ),
        "hbm_high_water": reg.ensure_gauge(
            "ps_device_hbm_high_water_bytes",
            "allocator peak bytes in use since process start "
            "(memory_stats peak_bytes_in_use)",
            labelnames=("device",),
        ),
        "hbm_limit": reg.ensure_gauge(
            "ps_device_hbm_bytes_limit",
            "allocator byte limit for the device (memory_stats)",
            labelnames=("device",),
        ),
        "hbm_frac_used": reg.ensure_gauge(
            "ps_device_hbm_frac_used",
            "bytes_in_use / bytes_limit at last collection — the "
            "gauge the HBM high-water alert rule watches",
            labelnames=("device",),
        ),
        "live_buffers": reg.ensure_gauge(
            "ps_device_live_buffer_bytes",
            "total nbytes of live jax arrays at last collection "
            "(jax.live_arrays — works on every backend, CPU included)",
        ),
        "live_high_water": reg.ensure_gauge(
            "ps_device_live_buffer_high_water_bytes",
            "process-lifetime high-water mark of the live-buffer total",
        ),
    }


def recovery_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Failure detection → recovery orchestration (system/recovery.py +
    the chaos plane, doc/ROBUSTNESS.md). ``RecoveryCoordinator.check``
    used to only log; these make detection volume, handler health and
    recovery latency visible to every snapshot — the drill's MTTR has
    a live counterpart."""
    return {
        "deaths": reg.ensure_counter(
            "ps_recovery_deaths_total",
            "nodes declared dead by the recovery coordinator (first "
            "detection only; revive + re-death counts again), by role",
            labelnames=("role",),
        ),
        "handler_failures": reg.ensure_counter(
            "ps_recovery_handler_failures_total",
            "recovery handler invocations that still failed after "
            "exhausting their retry policy (utils/retry.py backoff)",
        ),
        "seconds": reg.ensure_histogram(
            "ps_recovery_seconds",
            "wall time of one dead node's full recovery handling "
            "(every registered handler, retries included)",
            buckets=PHASE_BUCKETS,
        ),
    }


def node_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Per-node resource metrics for the cluster metrics plane
    (system/aux_runtime.py): each registered node owns a PRIVATE
    registry holding this family, refreshed from its HeartbeatReport at
    every metric report and shipped over the message plane for
    node-labeled aggregation (telemetry/aggregate.py — the ``node``
    label is added by the aggregator, which is why the family itself is
    unlabeled). Counters track the sampler's LIFETIME totals so
    cross-node sums stay monotone."""
    return {
        "heartbeats": reg.ensure_counter(
            "ps_node_heartbeats_total",
            "metric reports this node shipped onto the cluster plane",
        ),
        "busy": reg.ensure_counter(
            "ps_node_busy_seconds_total",
            "lifetime busy-timer seconds (HeartbeatInfo start/stop_timer)",
        ),
        "net_in": reg.ensure_counter(
            "ps_node_net_in_bytes_total",
            "lifetime bytes received by this node (Van transfer accounting)",
        ),
        "net_out": reg.ensure_counter(
            "ps_node_net_out_bytes_total",
            "lifetime bytes sent by this node (Van transfer accounting)",
        ),
        "rss_mb": reg.ensure_gauge(
            "ps_node_rss_mb",
            "resident set size at the node's last report (MB)",
        ),
        "cpu": reg.ensure_gauge(
            "ps_node_cpu_usage",
            "process cpu usage over the node's last report window "
            "(1.0 = one core)",
        ),
        "host_cpu": reg.ensure_gauge(
            "ps_node_host_cpu_usage",
            "whole-host cpu usage over the node's last report window",
        ),
        "uptime": reg.ensure_gauge(
            "ps_node_uptime_seconds",
            "seconds since the node's sampler started",
        ),
        "report_interval": reg.ensure_histogram(
            "ps_node_report_interval_seconds",
            "observed gap between this node's consecutive metric "
            "reports (bucket-merged across nodes in the cluster view)",
            buckets=PHASE_BUCKETS,
        ),
    }


def cluster_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """The aggregator's own health series (telemetry/aggregate.py):
    per-node liveness of the METRICS PLANE itself — rendered at the top
    of every /metrics scrape so a frozen node is marked
    (``ps_cluster_node_up 0`` + its report age) instead of its last
    values silently reading as current."""
    return {
        "nodes": reg.ensure_gauge(
            "ps_cluster_nodes",
            "nodes the aggregator has ever heard from (and not forgotten)",
        ),
        "node_up": reg.ensure_gauge(
            "ps_cluster_node_up",
            "1 while the node's last metric report is younger than the "
            "staleness window, else 0 (stale/dead)",
            labelnames=("node",),
        ),
        "report_age": reg.ensure_gauge(
            "ps_cluster_report_age_seconds",
            "age of the node's newest metric report at scrape time",
            labelnames=("node",),
        ),
        "reports": reg.ensure_counter(
            "ps_cluster_reports_total",
            "metric reports merged per node",
            labelnames=("node",),
        ),
        "conflicts": reg.ensure_counter(
            "ps_cluster_merge_conflicts_total",
            "distinct (node, metric) pairs rejected from the merge "
            "because the node re-declared the metric with a different "
            "kind or bucket layout (mis-merging would be worse than "
            "dropping; deduped — one persistently-bad export counts "
            "once, not once per scrape)",
        ),
    }


def blackbox_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Flight recorder (telemetry/blackbox.py): ring absorption volume
    and occupancy. The per-event hot path never touches the registry —
    these publish LAZILY from the sample/dump paths (the catalog's one
    deliberately-coarse family: a counter that lags by up to one
    metrics-sample interval, bought for a sub-noise-floor emit path)."""
    return {
        "events": reg.ensure_counter(
            "ps_blackbox_events_total",
            "span events absorbed by the flight-recorder ring "
            "(published lazily at sample/dump time, not per event)",
        ),
        "samples": reg.ensure_counter(
            "ps_blackbox_metrics_samples_total",
            "periodic metrics-delta samples recorded into the ring",
        ),
        "ring_events": reg.ensure_gauge(
            "ps_blackbox_ring_events",
            "events currently held by this process's recorder ring "
            "(<= capacity; older events have been evicted)",
        ),
    }


def bundle_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Diagnostic-bundle trigger plane (telemetry/blackbox.py):
    capture volume per trigger kind, rate-limit suppressions, capture
    cost. ``trigger`` is the closed KIND set (alert / degraded /
    node_death / executor_wait_timeout / scrape / manual — never the
    rule or node name, which would be unbounded label cardinality)."""
    return {
        "captures": reg.ensure_counter(
            "ps_bundle_captures_total",
            "diagnostic bundles captured, by trigger kind",
            labelnames=("trigger",),
        ),
        "suppressed": reg.ensure_counter(
            "ps_bundle_suppressed_total",
            "auto-capture triggers suppressed by the rate limit "
            "(a trigger storm costs one bundle, not one per symptom)",
        ),
        "capture_seconds": reg.ensure_histogram(
            "ps_bundle_capture_seconds",
            "wall time of one full bundle capture (ring fetches over "
            "the Van included)",
            buckets=PHASE_BUCKETS,
        ),
        "last_ring_nodes": reg.ensure_gauge(
            "ps_bundle_last_ring_nodes",
            "nodes represented (ring dump or staleness entry) in the "
            "most recent bundle",
        ),
    }


#: alert states exported by ps_alert_state (telemetry/alerts.py):
#: 0 inactive, 1 pending (condition holding, for_s not yet elapsed),
#: 2 firing, 3 resolved (recently cleared, held resolve_hold_s)
ALERT_STATES = ("inactive", "pending", "firing", "resolved")


def alert_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """SLO alerting (telemetry/alerts.py): each rule's live state and
    its transition history as counters — scrapers page on
    ``ps_alert_state == 2`` and the dashboard event log carries the
    same transitions for humans."""
    return {
        "state": reg.ensure_gauge(
            "ps_alert_state",
            "alert rule state: 0 inactive / 1 pending / 2 firing / "
            "3 resolved (recently cleared)",
            labelnames=("rule",),
        ),
        "transitions": reg.ensure_counter(
            "ps_alert_transitions_total",
            "alert state transitions, by rule and destination state",
            labelnames=("rule", "to"),
        ),
        # meta-monitoring (who watches the watcher): the evaluator's
        # own duration and schedule lag — the alert_evaluator_starved
        # default rule fires on the lag gauge
        "eval_seconds": reg.ensure_histogram(
            "ps_alert_eval_seconds",
            "wall seconds one alert-evaluation tick took (sample + "
            "every rule's compute + state advance)",
        ),
        "eval_lag": reg.ensure_gauge(
            "ps_alert_eval_lag_seconds",
            "seconds the latest evaluation started BEHIND its expected "
            "period (gap since the previous tick minus the period, "
            "floored at 0) — sustained lag means the evaluator thread "
            "is starving and alerts are going blind",
        ),
    }


def history_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """History plane (telemetry/history.py): the multi-resolution ring
    cascade's own accounting — fold cost, series occupancy, and the
    cardinality escape valve. ``dropped`` is the loud signal that a
    label explosion hit the caps: rings stay bounded, the overflow
    series lose history (never memory)."""
    return {
        "folds": reg.ensure_counter(
            "ps_history_folds_total",
            "registry-state folds landed in the ring cascade",
        ),
        "fold_seconds": reg.ensure_histogram(
            "ps_history_fold_seconds",
            "wall seconds one history fold took (read the registry "
            "export + update every resolution level)",
        ),
        "series": reg.ensure_gauge(
            "ps_history_series",
            "series currently tracked by the ring cascade",
        ),
        "dropped": reg.ensure_counter(
            "ps_history_dropped_series_total",
            "series REFUSED by the cardinality caps (per-metric or "
            "process-wide), by metric — each distinct series counts "
            "once; nonzero means some label set has no history",
            labelnames=("metric",),
        ),
        "collect_seconds": reg.ensure_gauge(
            "ps_registry_collect_seconds",
            "wall seconds the registry's last collector pass took "
            "(every snapshot/scrape runs it; the history fold "
            "publishes the registry's own measurement)",
        ),
    }


#: realized-staleness buckets (ps_learning_staleness): integer ministep
#: counts land between the .5 edges, so each small staleness value gets
#: its own bucket up to the configured-τ range anyone sanely runs
STALENESS_BUCKETS = (
    0.5, 1.5, 2.5, 3.5, 4.5, 6.5, 8.5, 12.5, 16.5, 24.5, 32.5, 48.5, 64.5,
)

#: reasons the divergence counter ticks (telemetry/learning.py):
#: nonfinite (NaN/Inf loss or gradient) or spike (grad norm far past
#: its recent median)
DIVERGENCE_REASONS = ("nonfinite", "spike")


def learning_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Learning truth plane (telemetry/learning.py): the staleness the
    bounded-delay contract actually REALIZES (vs the configured
    ``SGDConfig.max_delay`` τ), per-server-shard key heat from the
    windowed count sketch, and the convergence trajectory metered
    host-side from the step builders' in-jit side outputs. Five planes
    watch the system (seconds, bytes, FLOPs, incidents); this family
    watches the learning — a NaN'd table or a τ breach becomes a
    metric, an alert rule, and a bench-record section instead of a
    silent 200."""
    return {
        "staleness": reg.ensure_histogram(
            "ps_learning_staleness_ministeps",
            "realized weight-snapshot staleness of one submitted step, "
            "in ministeps since the snapshot was pulled (the "
            "bounded-delay contract's MEASURED side; observed max must "
            "stay <= the configured SGDConfig.max_delay)",
            labelnames=("worker",),
            buckets=STALENESS_BUCKETS,
        ),
        "staleness_max": reg.ensure_gauge(
            "ps_learning_staleness_max",
            "largest realized staleness this worker has observed "
            "(ministeps; process lifetime)",
            labelnames=("worker",),
        ),
        "staleness_over_tau": reg.ensure_gauge(
            "ps_learning_staleness_over_tau",
            "worst per-submission margin of realized staleness over the "
            "LIVE effective τ in force at submit time (the adaptive "
            "controller's bound when tau_adaptive, else the configured "
            "max_delay) — <= 0 while the bounded-delay contract holds; "
            "> 0 is a contract breach (the staleness_breach alert rule "
            "fires on this gauge)",
            labelnames=("worker",),
        ),
        "examples": reg.ensure_counter(
            "ps_learning_examples_total",
            "device-confirmed training examples folded into the "
            "progress plane by ISGDCompNode.collect (the step's own "
            "num_ex output, not a host-side submission count)",
            labelnames=("worker",),
        ),
        "loss": reg.ensure_gauge(
            "ps_learning_loss",
            "per-example training loss of the worker's last collected "
            "step (objective / num_ex)",
            labelnames=("worker",),
        ),
        "grad_norm": reg.ensure_gauge(
            "ps_learning_grad_norm",
            "L2 norm of the last collected step's per-worker gradient "
            "contributions (sqrt of the in-jit grad_sq side output)",
            labelnames=("worker",),
        ),
        "update_norm": reg.ensure_gauge(
            "ps_learning_update_norm",
            "L2 norm of the aggregated (post-filter) update handed to "
            "the updater on the last collected step",
            labelnames=("worker",),
        ),
        "weight_norm": reg.ensure_gauge(
            "ps_learning_weight_norm",
            "L2 magnitude of the weights the last collected step "
            "consumed (per-occurrence touched weights, not the global "
            "table norm — a blow-up detector and trend line)",
            labelnames=("worker",),
        ),
        "divergence": reg.ensure_counter(
            "ps_learning_divergence_total",
            "collected steps judged divergent host-side, by reason: "
            "nonfinite (NaN/Inf loss or gradient) or spike (grad norm "
            "far past its recent median) — the loss_divergence alert "
            "rule fires on this counter's rate",
            labelnames=("worker", "reason"),
        ),
        "heat_slots": reg.ensure_counter(
            "ps_learning_heat_slots_total",
            "slot observations folded into the key-heat sketch "
            "(pushed/pulled slots noted on the feeder/uploader threads)",
            labelnames=("worker",),
        ),
        "shard_share": reg.ensure_gauge(
            "ps_learning_shard_share",
            "this server shard's fraction of the windowed key-heat "
            "load (sums to ~1 across shards while traffic flows) — the "
            "direct input a declarative partitioner rebalances on",
            labelnames=("shard",),
        ),
        "shard_imbalance": reg.ensure_gauge(
            "ps_learning_shard_imbalance",
            "max/mean of per-shard windowed key-heat load — 1.0 is "
            "perfectly balanced; the shard_imbalance alert rule fires "
            "past its threshold",
        ),
    }


def partition_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Declarative partitioning + heat-driven live repartitioning
    (parallel/partition.py RebalanceController, KVVector.migrate)."""
    return {
        "rebalances": reg.ensure_counter(
            "ps_partition_rebalances_total",
            "live rebalances executed (shard_imbalance-triggered or "
            "forced): one consistent-snapshot migration each",
        ),
        "rows_moved": reg.ensure_counter(
            "ps_partition_rows_moved_total",
            "table rows relocated across server key ranges by live "
            "rebalances (hot slots + the cold slots they swapped with)",
        ),
        "migration_seconds": reg.ensure_histogram(
            "ps_partition_migration_seconds",
            "wall seconds per online migration: snapshot barrier -> "
            "host permute -> install + journal replay + directory flip",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        ),
        "post_imbalance": reg.ensure_gauge(
            "ps_partition_post_imbalance",
            "max/mean shard load imbalance after the latest rebalance "
            "(plan prediction, replaced by the re-measured value once "
            "post-rebalance traffic flows) — should sit below the "
            "shard_imbalance alert threshold",
        ),
    }


def consistency_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Self-driving consistency (learner/consistency.py): the adaptive
    τ controller's live bound + reactions, and the KKT significance
    filter's key accounting. The suppression counters reconcile
    in-record against ``ps_push_keys_total``:
    pushed + suppressed == candidates (the in-jit mask), and
    candidates + dropped == the unfiltered baseline (the host-side
    persistent-drop set) — bench records assert both identities."""
    return {
        "tau": reg.ensure_gauge(
            "ps_consistency_tau",
            "the LIVE effective bounded-delay τ this worker submits "
            "under right now (== configured max_delay while static; "
            "the AdaptiveTauController moves it between submissions)",
            labelnames=("worker",),
        ),
        "tau_changes": reg.ensure_counter(
            "ps_consistency_tau_changes_total",
            "τ moves the adaptive controller made, by direction: widen "
            "(stability-earned async headroom), clamp (grad-norm spike "
            "backoff), reset (divergence reaction to τ=0)",
            labelnames=("worker", "direction"),
        ),
        "suppressed": reg.ensure_counter(
            "ps_consistency_suppressed_keys_total",
            "unique slots the in-jit KKT mask suppressed from pushes "
            "(w == 0 and |z + g| inside the scaled L1 dead zone, net "
            "of the seeded starvation escape)",
            labelnames=("worker",),
        ),
        "candidates": reg.ensure_counter(
            "ps_consistency_candidate_keys_total",
            "unique real (non-padding) slots the filtered sparse step "
            "considered — pushed keys + suppressed keys must equal "
            "this (the in-record reconciliation identity)",
            labelnames=("worker",),
        ),
        "dropped": reg.ensure_counter(
            "ps_consistency_dropped_keys_total",
            "slot occurrences removed from batches HOST-SIDE before "
            "prep because the slot's suppression streak crossed "
            "kkt_drop_after (these never cost upload keys or bytes; "
            "periodically revisited via kkt_revisit_every)",
            labelnames=("worker",),
        ),
        "backoff": reg.ensure_counter(
            "ps_consistency_backoff_total",
            "automatic LR backoffs the divergence reaction applied "
            "(each also clamps τ to 0 and re-jits the weights fn)",
            labelnames=("worker",),
        ),
        "rollback": reg.ensure_counter(
            "ps_consistency_rollback_total",
            "snapshot rollbacks the divergence reaction executed, by "
            "trigger reason (nonfinite, spike, alert) — state restored "
            "to the controller's last healthy in-memory snapshot",
            labelnames=("worker", "reason"),
        ),
        "snapshot_age": reg.ensure_gauge(
            "ps_consistency_snapshot_age_steps",
            "collected steps since the controller's last healthy "
            "rollback snapshot (the rollback blast radius if the next "
            "collect diverges)",
            labelnames=("worker",),
        ),
    }


def app_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Application layer: RPC fan-out and training volume."""
    return {
        "rpcs": reg.ensure_counter(
            "ps_rpc_total",
            "ps.submit group RPCs delivered (request+auto-ack pairs)",
        ),
        "examples": reg.ensure_counter(
            "app_examples_total",
            "training examples submitted to device steps",
        ),
    }


def heartbeat_instruments(reg: MetricsRegistry) -> Dict[str, object]:
    """Node liveness/traffic as last-report gauges (aux_runtime.beat)."""
    return {
        "reports": reg.ensure_counter(
            "heartbeat_reports_total",
            "heartbeat reports collected",
            labelnames=("node",),
        ),
        "net_in_mb": reg.ensure_gauge(
            "node_net_in_mb",
            "bytes received since the node's previous report (MB)",
            labelnames=("node",),
        ),
        "net_out_mb": reg.ensure_gauge(
            "node_net_out_mb",
            "bytes sent since the node's previous report (MB)",
            labelnames=("node",),
        ),
    }


def _cached_family(family_fn):
    """Process-default accessor for one instrument family: returns a
    zero-arg callable yielding the family's instruments against the
    CURRENT default registry, or None while telemetry is disabled.
    The (registry, instruments) pair is cached per accessor and
    re-ensured only when tests swap the default registry
    (Postoffice.reset) — the call sites are hot paths (kv_ops pushes,
    per-request admission/coalescer stages, per-batch wire encodes)
    that must not re-ensure the family per call."""
    cache = (None, None)

    def accessor():
        nonlocal cache
        from . import registry as telemetry_registry

        if not telemetry_registry.enabled():
            return None
        reg = telemetry_registry.default_registry()
        if cache[0] is not reg:
            cache = (reg, family_fn(reg))
        return cache[1]

    accessor.__name__ = f"cached_{family_fn.__name__}"
    accessor.__qualname__ = accessor.__name__
    accessor.__doc__ = (
        f"Process-default {family_fn.__name__} (hot-path cache), or "
        "None when telemetry is off."
    )
    return accessor


# the one cache per hot-path family: data plane (kv_ops pushes,
# KVMap/KVLayer steps, KeyDirectory slot cache), request path
# (admission, coalescer, replica, frontend workers), wire
# (encode_exact, UploadCache), and the per-ministep FTRL path counter
# (AsyncSGDWorker._submit_prepped)
cached_kvops_instruments = _cached_family(kvops_instruments)
cached_serve_instruments = _cached_family(serve_instruments)
cached_wire_instruments = _cached_family(wire_instruments)
cached_ftrl_instruments = _cached_family(ftrl_instruments)
cached_device_instruments = _cached_family(device_instruments)
cached_learning_instruments = _cached_family(learning_instruments)
cached_blackbox_instruments = _cached_family(blackbox_instruments)
cached_bundle_instruments = _cached_family(bundle_instruments)
cached_partition_instruments = _cached_family(partition_instruments)
cached_consistency_instruments = _cached_family(consistency_instruments)


INSTRUMENT_FAMILIES = (
    executor_instruments,
    van_instruments,
    parameter_instruments,
    kvops_instruments,
    ingest_instruments,
    wire_instruments,
    serve_instruments,
    ftrl_instruments,
    device_instruments,
    learning_instruments,
    recovery_instruments,
    node_instruments,
    cluster_instruments,
    alert_instruments,
    history_instruments,
    blackbox_instruments,
    bundle_instruments,
    partition_instruments,
    consistency_instruments,
    app_instruments,
    heartbeat_instruments,
)


def install_all(reg: MetricsRegistry) -> Dict[str, object]:
    """Instantiate every declared instrument (metrics-lint entry point).
    Raises on duplicate names or declaration mismatches across families;
    returns name → instrument."""
    out: Dict[str, object] = {}
    for family in INSTRUMENT_FAMILIES:
        for inst in family(reg).values():
            out[inst.name] = inst
    return out
