"""HTTP exposition: /metrics, /healthz, /debug/snapshot.

The reference renders cluster health into a scheduler-side dashboard
(``src/system/dashboard.cc``); production systems scrape. This module
is the scrape point: a stdlib ``http.server`` daemon (no dependencies,
port 0 test-friendly, clean join on shutdown) serving

- ``/metrics`` — Prometheus text of the node-labeled cluster aggregate
  (telemetry/aggregate.py), text-format escaping included;
- ``/metrics/history`` — JSON range query over the history plane
  (telemetry/history.py): ``?name=<metric>[&window=600][&resolution=10]
  [&q=0.99][&labels={"k":"v"}]`` returns this node's ring cells plus
  every shipped per-node ring (staleness disclosed per node);
- ``/healthz`` — JSON heartbeat + recovery-coordinator state; **non-200
  (503)** while any shard is dead or its metric reports are stale;
- ``/debug/snapshot`` — JSON registry export + cluster view + alert
  states + the recent timeline tail, for humans mid-incident;
- ``/debug/bundle`` — a full diagnostic bundle (telemetry/blackbox.py:
  per-node flight-recorder rings with staleness, metrics snapshot,
  alert states, executors, Perfetto trace), floored at the scrape
  refresh interval so hammering it cannot re-drive the message plane.

Wiring is one call: :func:`expose_cluster` stands the endpoint up over
a started Postoffice (aux runtime + metric-report timer + default
alert rules), which is exactly what ``bench.py --expose-port``,
``apps/serve --expose-port`` and ``make metrics-serve`` do.
:class:`ExpositionServer` itself only needs three callables, so tests
(and single-registry processes) can serve anything.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from . import registry as telemetry_registry

#: Prometheus text exposition content type (the 0.0.4 text format)
CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


def _parse_history_query(raw_path: str):
    """``/metrics/history`` query string → (params dict, error string).

    Recognized params: ``name`` (required), ``window`` (seconds,
    default 600), ``resolution`` (seconds, optional — the store snaps
    to the coarsest level that still covers the window otherwise),
    ``q`` (quantile in (0, 1], histograms only), ``labels`` (a JSON
    object; subset match). A malformed value is a 400, not a guess —
    mid-incident a silently-defaulted window is worse than an error.
    """
    from urllib.parse import parse_qs, urlsplit

    try:
        qs = parse_qs(urlsplit(raw_path).query)
    except ValueError as e:
        return None, f"bad query string: {e}"
    name = (qs.get("name") or [""])[0].strip()
    if not name:
        return None, "missing required query param: name"
    params: dict = {"name": name, "window_s": 600.0}
    try:
        if "window" in qs:
            params["window_s"] = float(qs["window"][0])
        if "resolution" in qs:
            params["resolution"] = float(qs["resolution"][0])
        if "q" in qs:
            params["q"] = float(qs["q"][0])
    except ValueError as e:
        return None, f"bad numeric query param: {e}"
    if params["window_s"] <= 0:
        return None, "window must be > 0"
    if "labels" in qs:
        try:
            labels = json.loads(qs["labels"][0])
        except ValueError as e:
            return None, f"labels must be a JSON object: {e}"
        if not isinstance(labels, dict):
            return None, "labels must be a JSON object"
        params["labels"] = {str(k): str(v) for k, v in labels.items()}
    return params, None


class ExpositionServer:
    """One daemon HTTP server over three content callables.

    ``metrics_fn() -> str`` (Prometheus text), ``health_fn() ->
    (ok, detail_dict)`` (503 when not ok), ``snapshot_fn() -> dict``
    (JSON). ``history_fn(params) -> dict`` (optional) answers
    ``/metrics/history`` range queries with the parsed query params
    (see :func:`_parse_history_query`); absent → 404. ``port=0`` binds
    an ephemeral port (read :attr:`port` after :meth:`start`);
    :meth:`close` shuts the server down and JOINS the serving thread —
    no leaks for the tier-1 suite's thread guard.
    """

    def __init__(
        self,
        metrics_fn: Callable[[], str],
        health_fn: Optional[Callable[[], Tuple[bool, dict]]] = None,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        bundle_fn: Optional[Callable[[], dict]] = None,
        history_fn: Optional[Callable[[dict], dict]] = None,
    ):
        self.metrics_fn = metrics_fn
        self.health_fn = health_fn
        self.snapshot_fn = snapshot_fn
        self.bundle_fn = bundle_fn
        self.history_fn = history_fn
        self.host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --

    def start(self) -> "ExpositionServer":
        if self._httpd is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # one scrape is one response; keep-alive would pin handler
            # threads across scrape intervals
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
                pass  # scrapes are periodic; stderr spam helps no one

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — stdlib name
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = outer.metrics_fn().encode("utf-8")
                        self._send(200, body, CONTENT_TYPE_METRICS)
                    elif path == "/metrics/history":
                        if outer.history_fn is None:
                            self._send(
                                404, b"no history source\n", "text/plain"
                            )
                            return
                        params, err = _parse_history_query(self.path)
                        if err is not None:
                            self._send(
                                400, (err + "\n").encode(), "text/plain"
                            )
                            return
                        body = (json.dumps(
                            outer.history_fn(params), default=str
                        ) + "\n").encode()
                        self._send(200, body, "application/json")
                    elif path == "/healthz":
                        ok, detail = (
                            outer.health_fn()
                            if outer.health_fn is not None
                            else (True, {"ok": True, "note": "no health source"})
                        )
                        body = (json.dumps(detail, indent=2) + "\n").encode()
                        self._send(
                            200 if ok else 503, body, "application/json"
                        )
                    elif path == "/debug/snapshot":
                        snap = (
                            outer.snapshot_fn()
                            if outer.snapshot_fn is not None
                            else {}
                        )
                        body = (json.dumps(snap, indent=2, default=str)
                                + "\n").encode()
                        self._send(200, body, "application/json")
                    elif path == "/debug/bundle":
                        if outer.bundle_fn is None:
                            self._send(
                                404, b"no bundle source\n", "text/plain"
                            )
                        else:
                            body = (json.dumps(
                                outer.bundle_fn(), default=str
                            ) + "\n").encode()
                            self._send(200, body, "application/json")
                    elif path == "/":
                        body = (
                            b"parameter_server_tpu metrics endpoint\n"
                            b"/metrics /metrics/history?name=<metric> "
                            b"/healthz /debug/snapshot /debug/bundle\n"
                        )
                        self._send(200, body, "text/plain; charset=utf-8")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 — a broken
                    # renderer must answer 500, not hang the scraper
                    body = f"internal error: {type(e).__name__}: {e}\n".encode()
                    try:
                        self._send(500, body, "text/plain")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        # handler threads are daemonic; shutdown() below stops the
        # accept loop and close() joins the serving thread
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
            name="metrics-exposition",
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def serve_registry(
    reg=None, host: str = "127.0.0.1", port: int = 0
) -> ExpositionServer:
    """Minimal endpoint over ONE registry (no cluster plane): /metrics
    renders it directly, /healthz is always ok, /debug/snapshot is its
    snapshot. For single-registry processes and tests."""
    def metrics() -> str:
        r = reg or telemetry_registry.default_registry()
        return r.render_text()

    def snapshot() -> dict:
        r = reg or telemetry_registry.default_registry()
        return {"metrics": r.snapshot()}

    return ExpositionServer(metrics, None, snapshot, host=host, port=port).start()


def _timeline_tail(n: int = 64) -> dict:
    """Last ``n`` span events from the installed JSONL sink (tolerant
    of torn tails), with the sink's state DISCLOSED: an empty events
    list under ``sink: parked`` (a sink exists but is temporarily
    uninstalled — an embedded A/B is running) or ``sink: absent`` (no
    sink was ever installed) means "no trace captured", which is not
    the same claim as "nothing happened"."""
    from . import spans as telemetry_spans

    sink = telemetry_spans.get_sink()
    path = getattr(sink, "path", None)
    tail: dict = {
        "sink": telemetry_spans.sink_state(),
        "path": path,
        "events": [],
    }
    if not path:
        return tail
    try:
        from . import timeline

        tail["events"] = timeline.load_events(path)[-n:]
    except Exception:
        pass
    return tail


def expose_cluster(
    po=None,
    port: int = 0,
    host: str = "127.0.0.1",
    alerts: Optional[object] = None,
    alert_rules: Optional[list] = None,
    metrics_interval: float = 1.0,
    check_interval: float = 0.5,
    heartbeat_timeout: float = 10.0,
    stale_after_s: Optional[float] = None,
    register_nodes: bool = True,
) -> ExpositionServer:
    """Stand the full cluster metrics plane up over a started
    Postoffice: aux runtime (created if absent), every manager node
    registered as a heartbeat sampler, the metric-report timer running,
    the default SLO alert rules evaluating, and the HTTP endpoint
    serving the merged view. Returns the server; ``close_cluster(srv)``
    (or ``srv.close()`` + ``aux.stop()``) tears it down.

    ``alerts`` passes a prebuilt AlertManager; ``alert_rules`` builds
    one from a rule list; neither loads ``configs/alerts/default.json``.
    """
    from ..system.postoffice import Postoffice

    po = po or Postoffice.instance()
    aux = po.start_aux(heartbeat_timeout=heartbeat_timeout)
    if stale_after_s is not None:
        aux.cluster.stale_after_s = stale_after_s
    if register_nodes:
        for node in list(po.manager.nodes):
            aux.register(node.id)
    explicit = alerts is not None or alert_rules is not None
    if alerts is None:
        from .alerts import AlertManager, default_rules

        alerts = AlertManager(
            alert_rules if alert_rules is not None else default_rules()
        )
    # an EXPLICIT manager/rule set always installs (silently keeping
    # the old one would mean the caller's SLO rules never evaluate);
    # the implicit default only fills an empty slot
    if aux.alerts is None or (explicit and aux.alerts is not alerts):
        aux.set_alerts(alerts)
    aux.start(
        check_interval=check_interval, metrics_interval=metrics_interval
    )
    # the device-memory gauges (ps_device_hbm_*) refresh on every scrape
    from . import device as device_mod

    device_mod.install_hbm_monitor()

    def snapshot() -> dict:
        from . import history as history_mod
        from . import learning as learning_mod

        try:
            hist = {
                "local": history_mod.default_store().snapshot(),
                "cluster": aux.cluster.history_snapshot(),
            }
        except Exception as e:  # noqa: BLE001 — the snapshot must
            # render even if the history plane is mid-teardown
            hist = {"error": f"{type(e).__name__}: {e}"}
        return {
            "node_id": aux.node_id,
            "metrics": telemetry_registry.default_registry().snapshot(),
            "cluster": aux.cluster.snapshot(),
            "alerts": aux.alerts.snapshot() if aux.alerts else None,
            "health": aux.health()[1],
            # the learning truth plane per worker: staleness vs τ,
            # shard shares + imbalance, the top-k hot-slot table,
            # divergence accounting (doc/OBSERVABILITY.md "Learning
            # truth plane")
            "learning": learning_mod.snapshot_all(),
            # retention config + ring occupancy for this node, plus
            # per-node shipped-ring ages (doc/OBSERVABILITY.md
            # "History plane")
            "history": hist,
            "timeline_tail": _timeline_tail(),
        }

    def history_query(params: dict) -> dict:
        from . import history as history_mod

        store = history_mod.default_store()
        store.fold()  # capture the open second before answering
        local = store.query(
            params["name"],
            labels=params.get("labels"),
            window_s=params["window_s"],
            resolution=params.get("resolution"),
            q=params.get("q"),
        )
        cluster = aux.cluster.history_query(
            params["name"],
            labels=params.get("labels"),
            window_s=params["window_s"],
        )
        return {
            "query": params,
            "local": local,
            "nodes": cluster["nodes"],
        }

    srv = ExpositionServer(
        aux.metrics_text,
        aux.health,
        snapshot,
        host=host,
        port=port,
        bundle_fn=aux.bundle,
        history_fn=history_query,
    ).start()
    srv.aux = aux  # for close_cluster / callers that need the runtime
    return srv


def close_cluster(srv: Optional[ExpositionServer]) -> None:
    """Tear down an :func:`expose_cluster` server + its aux runtime
    (idempotent, None-safe — bench teardown paths call it from finally
    blocks)."""
    if srv is None:
        return
    srv.close()
    aux = getattr(srv, "aux", None)
    if aux is not None:
        aux.stop()


def _demo_main(argv=None) -> int:
    """A tiny live system (the port's linear worker on the card, or on
    ``--device cpu``, synthetic training ticking in the background) with
    the full metrics plane exposed: scrape
    http://127.0.0.1:<port>/metrics while it runs. Ctrl-C (or
    --duration) stops it cleanly. Run it with ``python -m
    parameter_server_tpu_torch.telemetry.exposition``."""
    import argparse
    import time

    ap = argparse.ArgumentParser(description=_demo_main.__doc__)
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="seconds to serve (0 = until Ctrl-C)")
    ap.add_argument("--steps-per-tick", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..apps.linear.config import (
        Config,
        LearningRateConfig,
        PenaltyConfig,
        SGDConfig,
    )
    from ..system.postoffice import Postoffice
    from ..utils.sparse import random_sparse

    Postoffice.reset()
    po = Postoffice.instance().start(device=args.device)
    srv = expose_cluster(po, port=args.port, metrics_interval=1.0)
    conf = Config()
    conf.penalty = PenaltyConfig(type="l1", lambda_=[0.01])
    conf.learning_rate = LearningRateConfig(type="decay", alpha=0.5, beta=1.0)
    conf.async_sgd = SGDConfig(
        algo="ftrl", minibatch=512, num_slots=1 << 12, max_delay=1
    )
    worker = AsyncSGDWorker(conf, device=po.device, name="metrics_demo")
    rng = np.random.default_rng(0)
    w_true = (rng.normal(size=1 << 12) * (rng.random(1 << 12) < 0.2)).astype(
        np.float32
    )
    print(f"metrics:  {srv.url}/metrics")
    print(f"healthz:  {srv.url}/healthz")
    print(f"snapshot: {srv.url}/debug/snapshot")
    t_end = time.monotonic() + args.duration if args.duration > 0 else None
    i = 0
    try:
        while t_end is None or time.monotonic() < t_end:
            worker.train(
                random_sparse(512, 1 << 12, 8, seed=i + j, w_true=w_true)
                for j in range(args.steps_per_tick)
            )
            i += args.steps_per_tick
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    finally:
        close_cluster(srv)
        worker.remove()
        po.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_demo_main())
