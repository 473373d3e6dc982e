"""Device truth plane: an inventory of the entry points that launch work
on the card, roofline gauges, and device-memory accounting.

Counterpart of ``parameter_server_tpu/telemetry/device.py``, with the
same public names and the same ``ps_device_*`` metrics. The JAX package
owns every ``lower().compile()`` of a jitted entry point; eager PyTorch
compiles nothing, so here the inventory keys each call by its input
signature instead, and the counts mean:

- ``ps_device_compiles_total{fn}``: the first use of each signature
  (shape, dtype and device of every tensor leaf, the type of every
  Python scalar, the value of every declared static) at an entry point;
- ``ps_device_recompiles_total{fn}``: signatures beyond a function's
  first, counted in the registry only once :func:`mark_warmup` was
  called, so a healthy steady state reads zero. In eager PyTorch a new
  signature after warm-up is a new shape at an entry point, which is
  what defeats the caching allocator and the kernels' tuned launches;
- ``ps_device_donation_fallbacks_total{fn}`` stays registered so the
  catalogs of the two packages match, and stays at zero: PyTorch does
  not donate buffers (every in-place update of the port writes the
  caller's tensor), so a declared donation cannot fall back to a copy;
- ``ps_device_dispatch_fallbacks_total{fn}`` counts calls whose
  signature could not be read. The wrapper then calls the function
  unchanged; the port has no second dispatch path, so on a healthy run
  it is zero.

Roofline: with sampling on (:func:`set_sampling`), every N-th call is
bracketed by a pair of CUDA events on the current stream. An event pair
is read only once the end event's ``query()`` is true, on a later call
or in a registry collection, never by blocking the calling thread:
``Event.elapsed_time`` waits for the event, which on the executor's
dispatch thread would collapse the steps in flight to one. The work of
a call is what the wrap point declares (``cost=``, a function of the
call's arguments returning ``{"flops", "bytes_accessed"}``, counted as
each benchmark counts its bound: each input read once, each output
written once; a value may be a tensor the card computes from the call's
data, copied to the host behind the call and read with its events);
achieved TFLOP/s and GB/s land in
``ps_device_kernel_tflops`` / ``ps_device_kernel_gb_s``, and their
shares of the card's peak (:data:`HBM_PEAK_GB_S`,
:data:`FLOPS_PEAK_TFLOPS`, looked up by ``torch.cuda.get_device_name``)
in ``ps_device_roofline_frac``. A card the tables do not know reports
no share. The events bracket everything the stream runs between them,
launch gaps included, so a share reads low, never high. On the CPU a
sampled call is timed by the host clock (the call is synchronous).

Memory (:class:`HbmMonitor`): a registry collector reading
``torch.cuda.memory_stats()`` (bytes allocated now and at the peak),
``torch.cuda.mem_get_info()`` (the card's total) and
``torch.cuda.memory_allocated()`` (the live tensor total and its
high-water mark), for every card this process has initialised; it never
initialises one itself.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import registry as telemetry_registry

#: HBM peak GB/s by card name (NVIDIA data sheets)
HBM_PEAK_GB_S: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

#: dense bf16 tensor-core peak TFLOP/s by card name (NVIDIA data sheets):
#: the denominator of every flops share, as in the JAX package
FLOPS_PEAK_TFLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def _peaks(device_kind: str) -> Tuple[Optional[float], Optional[float]]:
    """(HBM peak GB/s, bf16 peak TFLOP/s) for a card name, or Nones."""
    return HBM_PEAK_GB_S.get(device_kind), FLOPS_PEAK_TFLOPS.get(device_kind)


def _static_key(value) -> Any:
    """A declared static's cache key: its value, or its repr when it is
    not hashable."""
    try:
        hash(value)
        return value
    except TypeError:
        return repr(value)


def _leaf_sig(value) -> Any:
    """Hashable signature of one argument: tensors by (shape, dtype,
    device), containers and dataclasses field by field (a dataclass field
    marked ``static`` in its metadata by value, as a pytree's aux data),
    Python scalars by type (as a traced scalar is keyed by its aval),
    anything else by value."""
    if isinstance(value, torch.Tensor):
        return ("T", tuple(value.shape), value.dtype, value.device.type)
    if isinstance(value, (bool, int, float)):
        return type(value)
    if value is None or isinstance(value, str):
        return value
    if isinstance(value, (list, tuple)):
        return (type(value), tuple(_leaf_sig(v) for v in value))
    if isinstance(value, dict):
        return ("D", tuple((k, _leaf_sig(v)) for k, v in value.items()))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value), tuple(
            (f.name, _static_key(getattr(value, f.name)) if f.metadata.get("static")
             else _leaf_sig(getattr(value, f.name)))
            for f in dataclasses.fields(value)))
    shape = getattr(value, "shape", None)
    if shape is not None and hasattr(value, "dtype"):  # numpy arrays
        return ("A", tuple(shape), str(value.dtype))
    return _static_key(value)


def _canonical_call(sig, statics, args, kwargs):
    """Bind a call against the function's signature, apply declared
    defaults, and split it into ``(dynamic values by name, static
    values)``, so ``f(x)``, ``f(x, seed_default)`` and
    ``f(x, k=<default>)`` key alike. None when binding fails (the
    function then raises its own arity error)."""
    try:
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
    except TypeError:
        return None
    dyn: List[Tuple[str, Any]] = []
    static_vals: List[Tuple[str, Any]] = []
    for pname, v in bound.arguments.items():
        if pname in statics:
            static_vals.append((pname, v))
        elif sig.parameters[pname].kind == inspect.Parameter.VAR_KEYWORD:
            for k, vv in v.items():
                (static_vals if k in statics else dyn).append((k, vv))
        else:
            dyn.append((pname, v))
    static_vals.sort(key=lambda kv: kv[0])
    return dyn, tuple(static_vals)


def _staged(cost: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """A declared cost whose values may be tensors the card computed from
    the call's data (a count of live rows): each is copied to pinned host
    memory on the current stream, before the call, so it has landed once
    the call's end event has completed. Nothing waits here."""
    if not cost:
        return cost
    out = {}
    for k, v in cost.items():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            v = host
        out[k] = v
    return out


def _resolved(cost: Optional[Dict[str, Any]]) -> Optional[Dict[str, float]]:
    """A declared cost as floats (tensors read on the host: on the card
    only once the call is done, see :func:`_staged`)."""
    return {k: float(v) for k, v in cost.items()} if cost else cost


def _positional_key(sig, statics):
    """The key :func:`_canonical_call` gives a call with positional
    arguments only, without binding it: the parameters' names zipped
    with the arguments' signatures, then the defaults of the rest. For a
    function of plain parameters and no statics; None otherwise, and the
    returned function gives None where binding would fail."""
    params = list(sig.parameters.values())
    if statics or any(p.kind != inspect.Parameter.POSITIONAL_OR_KEYWORD for p in params):
        return None
    names = [p.name for p in params]
    defaults = [(p.name, p.default) for p in params]

    def key(args):
        rest = defaults[len(args):]
        if len(args) > len(names) or any(d is inspect.Parameter.empty for _, d in rest):
            return None
        return (tuple(zip(names, map(_leaf_sig, args)))
                + tuple((n, _leaf_sig(d)) for n, d in rest), ())

    return key


def aot_analyze(fn, *args, **kwargs) -> Optional[Dict[str, Any]]:
    """The work an instrumented entry point declares for these arguments:
    ``{"flops", "bytes_accessed", "donation_warned": False}``, or None
    when ``fn`` declares none. Nothing is compiled ahead of time in eager
    PyTorch; the counts are the wrap point's own."""
    cost_fn = getattr(fn, "__ps_cost__", None)
    if cost_fn is None:
        return None
    try:
        cost = cost_fn(*args, **kwargs)
    except Exception:
        return None
    if not cost:
        return None
    out: Dict[str, Any] = {"donation_warned": False}
    out.update({k: float(v) for k, v in cost.items()})
    return out


class _FnRecord:
    """Inventory state of one named function (all fields guarded by the
    owning inventory's lock)."""

    __slots__ = (
        "name", "compiles", "recompiles", "donation_fallbacks",
        "dispatch_fallbacks", "calls", "cost", "memory",
        "donated_bytes", "last_timing",
    )

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.recompiles = 0
        self.donation_fallbacks = 0
        self.dispatch_fallbacks = 0
        self.calls = 0
        self.cost: Optional[Dict[str, float]] = None      # latest sampled call
        self.memory: Optional[Dict[str, int]] = None      # no analysis in eager mode
        self.donated_bytes = 0
        self.last_timing: Optional[Dict[str, Any]] = None  # latest resolved sample

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "donation_fallbacks": self.donation_fallbacks,
            "calls": self.calls,
        }
        if self.dispatch_fallbacks:
            out["dispatch_fallbacks"] = self.dispatch_fallbacks
        if self.cost:
            out["cost"] = dict(self.cost)
        if self.last_timing:
            out["roofline"] = dict(self.last_timing)
        return out


def _device_tel():
    """The ps_device_* instruments against the current default registry,
    or None while telemetry is off (hot-path cached)."""
    from .instruments import cached_device_instruments

    return cached_device_instruments()


def _device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    try:
        return torch.cuda.get_device_name(device)
    except Exception:
        return "?"


def _first_device(values) -> Optional[torch.device]:
    """The device of the first tensor among a call's arguments."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, (list, tuple)):
            d = _first_device(v)
        elif isinstance(v, dict):
            d = _first_device(v.values())
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            d = _first_device(getattr(v, f.name) for f in dataclasses.fields(v))
        else:
            d = None
        if d is not None:
            return d
    return None


class _Seen(set):
    """A wrapper's seen signatures; a plain set is not weakref-able, and
    the inventory holds these weakly so a dead wrapper's set goes with it."""


class DeviceInventory:
    """Per-function records + the :meth:`instrument` wrap factory.

    Each wrapper owns its set of seen signatures; the inventory holds
    only the small per-NAME records. The steady-state call path takes
    the inventory lock only on a sampled call and on a new signature.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: Dict[str, _FnRecord] = {}  # guarded-by: _lock
        # read lock-free on every call (a GIL-atomic int); sampling
        # cadence is advisory
        self._sample_every = 0
        self._warmup_marks: Dict[str, Tuple[int, int]] = {}  # guarded-by: _lock
        self._warm = False  # guarded-by: _lock
        # sampled calls whose end event has not completed yet:
        # (name, start, end, cost, device name)
        self._open: List[Tuple[str, Any, Any, Dict[str, float], str]] = []  # guarded-by: _lock
        self._seen_sets: list = []  # weak refs to live wrappers' _Seen sets; guarded-by: _lock

    # -- configuration ----------------------------------------------------

    def set_sampling(self, every: int) -> int:
        """Time every N-th instrumented call (0 disables: the default).
        Returns the previous value."""
        with self._lock:
            prev, self._sample_every = self._sample_every, max(0, int(every))
        return prev

    def mark_warmup(self) -> None:
        """Record the current signature counts per function; from here on
        a new signature counts in ``ps_device_recompiles_total`` and in the
        snapshot's ``recompiles_post_warmup``."""
        with self._lock:
            self._warmup_marks = {
                name: (rec.compiles, rec.recompiles)
                for name, rec in self._records.items()
            }
            self._warm = True

    def reset(self) -> None:
        """Test hook: clear the records, the warm-up marks, the open
        samples and every live wrapper's seen signatures."""
        with self._lock:
            self._records.clear()
            self._warmup_marks.clear()
            self._warm = False
            self._open.clear()
            live = []
            for ref in self._seen_sets:
                seen = ref()
                if seen is not None:
                    seen.clear()
                    live.append(ref)
            self._seen_sets = live

    # -- the wrapper ------------------------------------------------------

    def instrument(
        self,
        name: str,
        fn,
        static_argnames: Sequence[str] = (),
        donate_argnums: Sequence[int] = (),
        cost: Optional[Callable[..., Optional[Dict[str, float]]]] = None,
    ):
        """Wrap ``fn`` into the inventory under ``name``. The wrapper
        returns what ``fn`` returns. ``static_argnames`` are keyed by
        value; ``donate_argnums`` is accepted for the JAX package's call
        shape and has no effect (see the module docstring); ``cost``
        declares the call's work for the roofline gauges. While
        telemetry is disabled, ``fn`` comes back unwrapped: an entry
        point built then pays nothing a call."""
        if not telemetry_registry.enabled():
            return fn
        statics = tuple(static_argnames)
        seen = _Seen()
        rec_box: list = []
        try:
            call_sig = inspect.signature(fn)
        except (TypeError, ValueError):
            call_sig = None
        positional_key = _positional_key(call_sig, statics) if call_sig is not None else None
        with self._lock:
            # prune dead wrappers' sets while registering
            self._seen_sets = [r for r in self._seen_sets if r() is not None]
            self._seen_sets.append(weakref.ref(seen))
        inv = self

        def call_key(args, kwargs):
            if positional_key is not None and not kwargs:
                key = positional_key(args)
                if key is not None:
                    return key
            split = None
            if call_sig is not None:
                split = _canonical_call(call_sig, statics, args, kwargs)
            if split is not None:
                dyn, static_vals = split
                return (tuple((k, _leaf_sig(v)) for k, v in dyn),
                        tuple((k, _static_key(v)) for k, v in static_vals))
            return (_leaf_sig(args), _leaf_sig(
                {k: v for k, v in kwargs.items() if k not in statics}),
                tuple((k, _static_key(kwargs[k])) for k in statics if k in kwargs))

        def wrapper(*args, **kwargs):
            try:
                key = call_key(args, kwargs)
                hash(key)
            except Exception:
                inv._count_fallback(name)
                return fn(*args, **kwargs)
            if key not in seen:
                inv._new_signature(name, seen, rec_box, key)
            rec = rec_box[0] if rec_box else None
            sample = False
            if rec is not None:
                rec.calls += 1  # benign GIL race: advisory counter
                se = inv._sample_every
                sample = se > 0 and rec.calls % se == 0
            if not sample:
                return fn(*args, **kwargs)
            return inv._sampled_call(name, fn, cost, args, kwargs)

        wrapper.__name__ = f"instrumented_{name}"
        wrapper.__qualname__ = wrapper.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        wrapper.__ps_cost__ = cost
        return wrapper

    # -- internals --------------------------------------------------------

    def _new_signature(self, name, seen, rec_box, key) -> None:
        tel = _device_tel()
        with self._lock:
            if key in seen:
                return  # a racing first call recorded it
            seen.add(key)
            rec = self._records.get(name)
            if rec is None:
                rec = self._records[name] = _FnRecord(name)
            rec_box[:] = [rec]  # refresh: reset() may have swapped it
            rec.compiles += 1
            recompile = rec.compiles > 1
            if recompile:
                rec.recompiles += 1
            count_recompile = recompile and self._warm
        if tel is not None:
            tel["compiles"].labels(fn=name).inc()
            if count_recompile:
                tel["recompiles"].labels(fn=name).inc()

    def _sampled_call(self, name, fn, cost_fn, args, kwargs):
        cost = None
        if cost_fn is not None:
            try:
                cost = cost_fn(*args, **kwargs)
            except Exception:
                cost = None
        device = _first_device(list(args) + list(kwargs.values()))
        if device is not None and device.type == "cuda":
            cost = _staged(cost)
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args, **kwargs)
            end.record(stream)
            with self._lock:
                self._open.append((name, start, end, cost, _device_name(device)))
            self.poll()
            return out
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._observe_timing(name, time.perf_counter() - t0, _resolved(cost),
                             _device_name(device or torch.device("cpu")))
        return out

    def poll(self) -> int:
        """Fold every sampled call whose end event has completed into the
        gauges, without waiting for any; returns how many are still open."""
        with self._lock:
            open_, self._open = self._open, []
        still = []
        for item in open_:
            name, start, end, cost, kind = item
            try:
                done = end.query()
            except Exception:
                continue
            if not done:
                still.append(item)
                continue
            try:
                wall_s = start.elapsed_time(end) / 1e3
            except Exception:
                continue
            self._observe_timing(name, wall_s, _resolved(cost), kind)
        with self._lock:
            self._open = still + self._open
            return len(self._open)

    def _count_fallback(self, name: str) -> None:
        with self._lock:
            rec = self._records.get(name)
            if rec is None:
                rec = self._records[name] = _FnRecord(name)
            rec.dispatch_fallbacks += 1
        tel = _device_tel()
        if tel is not None:
            tel["dispatch_fallbacks"].labels(fn=name).inc()

    def _observe_timing(self, name: str, wall_s: float,
                        cost: Optional[Dict[str, float]], kind: str) -> None:
        """Fold one timed call into the function's roofline view and the
        live gauges; shares exist only for cards the peak tables know."""
        with self._lock:
            rec = self._records.get(name)
            if rec is not None and cost:
                rec.cost = dict(cost)
        if not cost or wall_s <= 0:
            return
        hbm_peak, flops_peak = _peaks(kind)
        timing: Dict[str, Any] = {"wall_ms": round(wall_s * 1e3, 4)}
        tel = _device_tel()
        gb_s = tflops = None
        if cost.get("bytes_accessed"):
            gb_s = cost["bytes_accessed"] / wall_s / 1e9
            timing["achieved_gb_s"] = round(gb_s, 3)
        if cost.get("flops"):
            tflops = cost["flops"] / wall_s / 1e12
            timing["achieved_tflops"] = round(tflops, 5)
        if hbm_peak and gb_s is not None:
            timing["frac_of_hbm_peak"] = round(gb_s / hbm_peak, 5)
        if flops_peak and tflops is not None:
            timing["mfu"] = round(tflops / flops_peak, 6)
        with self._lock:
            if rec is not None:
                rec.last_timing = timing
        if tel is not None:
            if gb_s is not None:
                tel["kernel_gb_s"].labels(fn=name).set(gb_s)
            if tflops is not None:
                tel["kernel_tflops"].labels(fn=name).set(tflops)
            if "frac_of_hbm_peak" in timing:
                tel["roofline_frac"].labels(fn=name, resource="hbm").set(
                    timing["frac_of_hbm_peak"]
                )
            if "mfu" in timing:
                tel["roofline_frac"].labels(fn=name, resource="flops").set(
                    timing["mfu"]
                )

    # -- reads ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The record-embeddable inventory view: per-function signature
        counts with the latest declared cost and resolved sample, plus
        the post-warm-up total (zero on a healthy steady-state run)."""
        self.poll()
        with self._lock:
            fns = {
                name: rec.as_dict()
                for name, rec in sorted(self._records.items())
            }
            marks = dict(self._warmup_marks)
            recs = dict(self._records)
            warm = self._warm
        post_warmup = 0
        for name, rec in recs.items():
            c0, _ = marks.get(name, (0, 0))
            # a function first used AFTER the mark is warm-up debt too
            post_warmup += (rec.compiles - c0) if name in marks else rec.compiles
        return {
            "functions": fns,
            "recompiles_post_warmup": post_warmup if warm else None,
            "donation_fallbacks_total": sum(
                rec.donation_fallbacks for rec in recs.values()
            ),
        }


class HbmMonitor:
    """Registry collector for device-memory truth.

    ``collect()`` runs before every snapshot/render (the registry
    collector contract): for each card this process has initialised,
    ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` and
    ``.peak``) and ``mem_get_info()``'s total as the limit, plus the
    live tensor total (``memory_allocated``) with a process-lifetime
    high-water mark. It never initialises CUDA itself, so on a CPU run
    the device family stays empty and the live total reads 0. The owner
    must keep a strong reference (collectors are weakrefs);
    :func:`install_hbm_monitor` parks it module-side.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._live_high_water = 0  # guarded-by: _lock
        self._last: Dict[str, Any] = {}  # guarded-by: _lock

    @staticmethod
    def read() -> Dict[str, Dict[str, int]]:
        """Per-card allocator stats, keyed ``cuda:<i>``."""
        devices: Dict[str, Dict[str, int]] = {}
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return devices
        for i in range(torch.cuda.device_count()):
            try:
                ms = torch.cuda.memory_stats(i)
                _, total = torch.cuda.mem_get_info(i)
            except Exception:
                continue
            devices[f"cuda:{i}"] = {
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(total),
            }
        return devices

    def collect(self) -> None:
        tel = _device_tel()
        devices = self.read()
        live_bytes = sum(d["bytes_in_use"] for d in devices.values())
        with self._lock:
            self._live_high_water = max(self._live_high_water, live_bytes)
            high = self._live_high_water
            self._last = {
                "live_buffer_bytes": live_bytes,
                "live_buffer_high_water_bytes": high,
                "devices": devices,
            }
        if tel is None:
            return
        tel["live_buffers"].set(live_bytes)
        tel["live_high_water"].set(high)
        for label, stats in devices.items():
            tel["hbm_bytes_in_use"].labels(device=label).set(stats["bytes_in_use"])
            tel["hbm_high_water"].labels(device=label).set(stats["peak_bytes_in_use"])
            tel["hbm_limit"].labels(device=label).set(stats["bytes_limit"])
            if stats["bytes_limit"]:
                tel["hbm_frac_used"].labels(device=label).set(
                    stats["bytes_in_use"] / stats["bytes_limit"]
                )

    def snapshot(self) -> Dict[str, Any]:
        """Freshly collected memory view for a record."""
        self.collect()
        with self._lock:
            return dict(self._last)


# -- module-level plumbing (the process-default inventory) -----------------

_default_inventory = DeviceInventory()
_hbm_monitor: Optional[HbmMonitor] = None
_hbm_lock = threading.Lock()


def inventory() -> DeviceInventory:
    return _default_inventory


def instrument(
    name: str,
    fn,
    static_argnames: Sequence[str] = (),
    donate_argnums: Sequence[int] = (),
    cost: Optional[Callable[..., Optional[Dict[str, float]]]] = None,
):
    """``DeviceInventory.instrument`` against the process inventory: the
    one-liner for the wrap points (``ops/kv_ops``, the linear step
    builders, the LM train step)."""
    return _default_inventory.instrument(
        name, fn, static_argnames=static_argnames,
        donate_argnums=donate_argnums, cost=cost,
    )


def set_sampling(every: int) -> int:
    return _default_inventory.set_sampling(every)


def mark_warmup() -> None:
    _default_inventory.mark_warmup()


def reset() -> None:
    """Test hook: clear the process inventory."""
    _default_inventory.reset()


def hbm_monitor() -> HbmMonitor:
    """The process HbmMonitor (created on first use; NOT yet registered
    as a collector: see :func:`install_hbm_monitor`)."""
    global _hbm_monitor
    with _hbm_lock:
        if _hbm_monitor is None:
            _hbm_monitor = HbmMonitor()
        return _hbm_monitor


def _poll_samples() -> None:
    _default_inventory.poll()


def install_hbm_monitor(reg=None) -> Optional[HbmMonitor]:
    """Register the memory collector (and the sweep that folds finished
    roofline samples) on ``reg`` (the default registry when None), so
    every snapshot/scrape carries fresh ``ps_device_*`` gauges.
    Idempotent per registry. No-op returning None while telemetry is
    disabled."""
    if reg is None:
        if not telemetry_registry.enabled():
            return None
        reg = telemetry_registry.default_registry()
    mon = hbm_monitor()
    if not getattr(reg, "_ps_device_hbm_installed", False):
        reg.add_collector(mon.collect)
        reg.add_collector(_poll_samples)
        try:
            reg._ps_device_hbm_installed = True
        except Exception:
            pass
    return mon


def snapshot() -> Dict[str, Any]:
    """The ``device`` section of a record: inventory counters, declared
    costs and samples, and the memory view, stamped with the card."""
    out = _default_inventory.snapshot()
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            kind = torch.cuda.get_device_name(0)
            out["backend"] = "cuda"
        else:
            kind = "cpu"
            out["backend"] = "cpu"
        out["device_kind"] = kind
        hbm_peak, flops_peak = _peaks(kind)
        out["hbm_peak_gb_s"] = hbm_peak
        out["flops_peak_tflops"] = flops_peak
    except Exception:
        pass
    out["hbm"] = hbm_monitor().snapshot()
    return out
