"""PyTorch port: alert-driven autoscaling (``system/autoscale.py``'s
``AlertDrivenScaler``) against the JAX package's scaler.

The scaler is host code copied from the JAX package: each case drives the
JAX scaler and the port's with the same events, clocks and fleets, and
holds the port's actions, grown counts, fleet sizes and flight-recorder
bundles equal to the JAX ones (the JAX package's alert plane feeds the
JAX scaler, the port's the port's). The default action on a real
coordinator runs in a gloo world of 6 CPU ranks
(``tests/torch_elastic_ranks.py::autoscale_default_action``: every rank
delivers the same firing event, so every rank's scaler grows the mesh
from 2x2 to 3x2).
"""

import pytest

from parameter_server_tpu.system.autoscale import AlertDrivenScaler as JScaler
from parameter_server_tpu.telemetry import alerts as jalerts
from parameter_server_tpu.telemetry import blackbox as jblackbox
from parameter_server_tpu.telemetry import history as jhistory
from parameter_server_tpu.telemetry import registry as jregistry
from parameter_server_tpu_torch.parallel import launch
from parameter_server_tpu_torch.system.autoscale import AlertDrivenScaler as TScaler
from parameter_server_tpu_torch.telemetry import alerts as talerts
from parameter_server_tpu_torch.telemetry import blackbox as tblackbox
from parameter_server_tpu_torch.telemetry import history as thistory
from parameter_server_tpu_torch.telemetry import registry as tregistry
from tests import torch_elastic_ranks as ranks

SIDES = {
    "jax": (JScaler, jalerts, jblackbox, jhistory, jregistry),
    "port": (TScaler, talerts, tblackbox, thistory, tregistry),
}


def _event(alerts, rule="serve_p99_burn", to="firing", frm="inactive", value=0.2):
    return alerts.AlertEvent(rule=rule, frm=frm, to=to, value=value, threshold=0.05, op=">",
                             t=0.0, severity="page")


class _Manager:
    """A stand-in AlertManager: the listener registry."""

    def __init__(self):
        self.listeners = []

    def add_listener(self, fn):
        self.listeners.append(fn)

    def deliver(self, ev):
        for fn in self.listeners:
            fn(ev)


class _Fleet:
    def __init__(self, size=2):
        self.size = size

    def add_worker(self):
        self.size += 1
        return self.size


@pytest.fixture(autouse=True)
def fresh_blackbox():
    jblackbox.reset()
    tblackbox.reset()
    yield
    jblackbox.reset()
    tblackbox.reset()


def _actions(sc):
    return [{k: v for k, v in a.items() if k != "t"} for a in sc.actions()]


def _both(run):
    """``run(side modules)`` on the JAX side and on the port's; returns
    both results, which each case then holds equal."""
    return {name: run(*mods) for name, mods in SIDES.items()}


def test_firing_grows_and_captures_bundle():
    def run(Scaler, alerts, blackbox, *_):
        mgr, fleet = _Manager(), _Fleet(size=2)
        sc = Scaler(mgr, fleet, cooldown_s=0.0)
        blackbox.set_min_interval(0.0)
        mgr.deliver(_event(alerts, to="firing"))
        b = blackbox.last_bundle()
        return fleet.size, sc.grown(), _actions(sc), b["trigger"]["kind"], b["trigger"]["detail"]

    got = _both(run)
    assert got["port"] == got["jax"]
    size, grown, actions, kind, detail = got["port"]
    assert size == 3 and grown == 1 and [a["outcome"] for a in actions] == ["grew"]
    assert kind == "alert" and "serve_p99_burn firing -> grew" in detail


def test_other_rules_ignored():
    def run(Scaler, alerts, *_):
        mgr, fleet = _Manager(), _Fleet()
        sc = Scaler(mgr, fleet, cooldown_s=0.0)
        mgr.deliver(_event(alerts, rule="train_stale_exceeded", to="firing"))
        mgr.deliver(_event(alerts, to="pending", frm="inactive"))
        return fleet.size, _actions(sc)

    got = _both(run)
    assert got["port"] == got["jax"] == (2, [])


def test_cooldown_spaces_actions():
    def run(Scaler, alerts, *_):
        mgr, fleet = _Manager(), _Fleet()
        t = [0.0]
        sc = Scaler(mgr, fleet, cooldown_s=60.0, clock=lambda: t[0])
        mgr.deliver(_event(alerts, to="firing"))
        t[0] = 30.0  # inside the cooldown: a flapping alert must not saw
        mgr.deliver(_event(alerts, to="firing", frm="resolved"))
        mid = (fleet.size, [a["outcome"] for a in sc.actions()])
        t[0] = 90.0
        mgr.deliver(_event(alerts, to="firing", frm="resolved"))
        return mid, fleet.size, [a["t"] for a in sc.actions()]

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (3, ["grew", "skipped-cooldown"]) and got["port"][1] == 4


def test_max_workers_bounds_growth():
    def run(Scaler, alerts, *_):
        mgr, fleet = _Manager(), _Fleet()
        sc = Scaler(mgr, fleet, cooldown_s=0.0, max_workers=1)
        mgr.deliver(_event(alerts, to="firing"))
        mgr.deliver(_event(alerts, to="firing", frm="resolved"))
        return fleet.size, sc.grown(), sc.actions()[-1]["outcome"]

    got = _both(run)
    assert got["port"] == got["jax"] == (3, 1, "skipped-max-workers")


def test_grow_errors_are_fenced():
    def run(Scaler, alerts, *_):
        mgr = _Manager()

        def boom():
            raise RuntimeError("resize wedged")

        sc = Scaler(mgr, _Fleet(), cooldown_s=0.0, grow=boom)
        mgr.deliver(_event(alerts, to="firing"))
        act = sc.actions()[-1]
        return sc.grown(), act["outcome"], act["result"]

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (0, "error") and "resize wedged" in got["port"][2]


def test_resolved_without_action_stays_quiet():
    def run(Scaler, alerts, blackbox, *_):
        mgr = _Manager()
        Scaler(mgr, _Fleet())
        blackbox.set_min_interval(0.0)
        mgr.deliver(_event(alerts, to="resolved", frm="firing"))
        return blackbox.last_bundle()

    got = _both(run)
    assert got["port"] is None and got["jax"] is None


def test_default_action_is_add_worker():
    """The default actuator is ``ElasticCoordinator.add_worker``: a firing
    event grows the data axis by one and rebuilds the worker on the new
    mesh, on every rank of a world of 6."""
    recs = launch.run_world(ranks.autoscale_default_action, 6, device_type="cpu", timeout=240)
    for r, rec in enumerate(recs):
        assert rec["before"] == 2 and rec["after"] == 3
        assert rec["outcomes"] == ["grew"]
        assert rec["shape"][0] == {"data": 3, "server": 2}
        assert rec["has_worker"] and rec["shape"][1] == divmod(r, 2)


def test_overload_resize_resolve_arc():
    """The acceptance drill on the fake clock, on both sides: a sustained
    decode p99 burn fires ``serve_p99_burn`` (15 s AND 120 s windows over
    ``ps_serve_latency_seconds``), the listener grows the fleet, latency
    recovers, the alert resolves with no human action, and the flight
    recorder holds the overload → resize → resolve arc; the port's arc
    (transitions, fire and resolve times, actions, bundles) equals the
    JAX one."""

    def run(Scaler, alerts, blackbox, history, registry):
        reg = registry.MetricsRegistry()
        lat = reg.histogram("ps_serve_latency_seconds", "decode latency",
                            buckets=(0.001, 0.01, 0.05, 0.25, 1.0))
        t = [0.0]
        st = history.HistoryStore(reg, resolutions=((1.0, 600), (10.0, 720)),
                                  clock=lambda: t[0])
        rule = alerts.AlertRule(name="serve_p99_burn", kind="quantile",
                                metric="ps_serve_latency_seconds", q=0.99, op=">",
                                threshold=0.05, window_s=15.0, slow_window_s=120.0, for_s=0.0,
                                severity="page")
        mgr = alerts.AlertManager([rule], registry=reg, clock=lambda: t[0], history=st)
        fleet = _Fleet(size=2)
        scaler = Scaler(mgr, fleet, cooldown_s=30.0, clock=lambda: t[0])
        blackbox.set_min_interval(0.0)
        transitions = []
        mgr.add_listener(lambda ev: transitions.append(ev.to))
        overload_from = 130.0
        fired_at = resolved_at = None
        quiet = True
        for i in range(1, 60):
            t[0] = 10.0 * i
            hot = t[0] >= overload_from and fleet.size < 3
            for _ in range(20):
                lat.observe(0.2 if hot else 0.005)
            mgr.evaluate()
            name = mgr.states()["serve_p99_burn"].state_name
            if name == "firing" and fired_at is None:
                fired_at = t[0]
            if t[0] < overload_from:
                quiet = quiet and name == "inactive"
            if name == "resolved":
                resolved_at = t[0]
                break
        details = [b["trigger"]["detail"] for b in blackbox.bundles()
                   if b["trigger"]["kind"] == "alert"]
        return dict(transitions=transitions, fired_at=fired_at, resolved_at=resolved_at,
                    quiet=quiet, size=fleet.size, actions=_actions(scaler), details=details)

    got = _both(run)
    assert got["port"] == got["jax"]
    arc = got["port"]
    assert arc["quiet"] and arc["fired_at"] is not None and arc["fired_at"] >= 130.0
    assert arc["resolved_at"] is not None and arc["resolved_at"] > arc["fired_at"]
    assert arc["size"] == 3 and [a["outcome"] for a in arc["actions"]][:1] == ["grew"]
    assert any("firing -> grew" in d for d in arc["details"]), arc["details"]
    assert any("resolved after autoscale" in d for d in arc["details"]), arc["details"]
