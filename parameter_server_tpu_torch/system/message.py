"""Tasks and messages — the host control plane.

Counterpart of ``parameter_server_tpu/system/message.py`` (the
reference's ``src/system/message.{h,cc}`` + ``proto/task.proto``). A
``Task`` carries the scheduling metadata of one logical step (time,
wait_time dependencies, key range, channel, filters); the port's
:class:`~.executor.Executor` orders steps by it, so the one ``Task``
here is what ``Customer.submit``, ``Parameter.request`` and the
executor all take. A ``Message`` carries a task and host array
references; ``to_bytes``/``from_bytes`` frame it for the wire with a
restricted unpickler for the header.

Pickled headers name this module (``parameter_server_tpu_torch.system
.message``), so a frame of the port is not a frame of the JAX package
and the other way round: each unpickler admits only its own package's
wire types.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..utils.range import Range

INVALID_TIME = -1

# builtins reachable via pickle's find_class that are data, not code
_SAFE_BUILTINS = {"complex", "range", "slice", "frozenset", "set", "bytearray"}
# exact (module, name) pairs for the numpy machinery array/scalar pickles
# actually use — NOT a module prefix: numpy also exports file writers
# (numpy.save), dlopen helpers (ctypeslib.load_library) and classes with
# side-effectful constructors (numpy.memmap)
_SAFE_NUMPY = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}
# the closed set of package types that legitimately ride a wire header
# (the Task graph). NOT "any package class": instantiating e.g. Customer
# registers phantom customers with the receiver's postoffice — package
# constructors can carry side effects even when no stdlib code is
# reachable. Extend this set when a new type genuinely joins the wire.
_SAFE_PACKAGE = {
    ("parameter_server_tpu_torch.system.message", "Task"),
    ("parameter_server_tpu_torch.system.message", "FilterSpec"),
    ("parameter_server_tpu_torch.system.message", "Command"),
    ("parameter_server_tpu_torch.utils.range", "Range"),
    # heartbeat/metrics reports ride the message plane (the aux
    # runtime's metric reports, monitor progress): a plain dataclass of
    # floats and one hostname string, no side effects on construction
    ("parameter_server_tpu_torch.system.heartbeat", "HeartbeatReport"),
}


def _restricted_loads(blob: bytes):
    """Unpickle a wire header allowing only this package's classes, the
    exact numpy reconstruction machinery, and plain-data builtins.

    Defenses (each closes a demonstrated bypass class):
    - names containing '.' are rejected outright — protocol-4
      STACK_GLOBAL resolves dotted names by attribute traversal, so an
      allowed module would otherwise reach e.g. ``cpp.subprocess.run``;
    - the package allowance is the closed ``_SAFE_PACKAGE`` set of wire
      dataclasses, not "any package class" — constructors like
      ``Customer()`` mutate receiver state (postoffice registration);
    - numpy is a closed (module, name) set, not a prefix;
    - numpy dtype classes (numpy 2 pickles dtypes as
      ``numpy.dtypes.Float64DType``) are allowed as types only.
    """
    import io
    import pickle

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module: str, name: str):
            def deny() -> None:
                raise pickle.UnpicklingError(
                    f"wire frame names forbidden global {module}.{name}"
                )

            if "." in name:  # STACK_GLOBAL attribute traversal
                deny()
            if (module, name) in _SAFE_PACKAGE:
                return super().find_class(module, name)
            if module.startswith(("parameter_server_tpu_torch.", "parameter_server_tpu.")):
                deny()
            if (module, name) in _SAFE_NUMPY:
                return super().find_class(module, name)
            if module == "numpy.dtypes":
                obj = super().find_class(module, name)
                if not isinstance(obj, type):
                    deny()
                return obj
            if module == "collections" and name == "OrderedDict":
                return super().find_class(module, name)
            if module == "builtins" and name in _SAFE_BUILTINS:
                return super().find_class(module, name)
            deny()

    return _Unpickler(io.BytesIO(blob)).load()


class Command(enum.Enum):
    """Control commands (ref task.proto Control/ManageNode + sgd.proto
    SGDCall + bcd.proto BCDCall command enums, collapsed)."""

    TERMINATE = "terminate"
    REQUEST_WORKLOAD = "request_workload"
    UPDATE_MODEL = "update_model"
    PREPROCESS_DATA = "preprocess_data"
    EVALUATE_PROGRESS = "evaluate_progress"
    SAVE_MODEL = "save_model"
    RECOVER = "recover"
    HEARTBEAT = "heartbeat"
    # flight-recorder ring fetch (telemetry/blackbox.py): a node ships
    # its bounded event ring to the scheduler for a diagnostic bundle
    DUMP_BLACKBOX = "dump_blackbox"


#: the closed key set a wire trace context may carry (Task.trace)
_TRACE_KEYS = {"flow", "node", "t_send"}


def _validate_trace(trace: Any) -> Optional[dict]:
    """Validate a decoded header's trace context (Task.trace).

    The field rides the restricted unpickler like the rest of the Task,
    but the unpickler only bounds WHICH types can be named — a hostile
    peer could still smuggle an arbitrarily nested container or a
    numpy payload into the slot the receiver later re-activates as a
    flow scope. This narrows it to the closed shape
    :func:`telemetry.spans.trace_context` emits: a flat dict of at
    most {flow: int, node: short str, t_send: finite float}. Anything
    else raises ``ValueError`` loudly (the from_bytes malformed-frame
    contract); absent/None decodes as None (legacy peers, tracing off).
    """
    if trace is None:
        return None
    if type(trace) is not dict or set(trace) - _TRACE_KEYS:
        raise ValueError(
            f"wire frame carries malformed trace context: {trace!r:.120}"
        )
    flow = trace.get("flow")
    if flow is not None and (
        type(flow) is not int or not 0 < flow < (1 << 63)
    ):
        raise ValueError(
            f"wire frame trace context has non-int flow {flow!r:.80}"
        )
    node = trace.get("node")
    if node is not None and (type(node) is not str or len(node) > 64):
        raise ValueError(
            f"wire frame trace context has bad node id {node!r:.80}"
        )
    t_send = trace.get("t_send")
    if t_send is not None and (
        type(t_send) not in (int, float)
        or not (-1e12 < float(t_send) < 1e12)
    ):
        raise ValueError(
            f"wire frame trace context has bad t_send {t_send!r:.80}"
        )
    return trace


@dataclasses.dataclass
class FilterSpec:
    """A filter application (ref proto/filter.proto FilterConfig)."""

    type: str  # 'key_caching' | 'compressing' | 'fixing_float' | 'add_noise' | 'sparse'
    num_bytes: int = 0  # fixing_float width
    clear_cache_if_done: bool = False
    mean: float = 0.0
    std: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Task:
    """Scheduling metadata for one logical step (ref task.proto Task)."""

    request: bool = True
    time: int = INVALID_TIME
    wait_time: List[int] = dataclasses.field(default_factory=list)
    key_channel: int = 0
    key_range: Range = dataclasses.field(default_factory=Range.all)
    filters: List[FilterSpec] = dataclasses.field(default_factory=list)
    cmd: Optional[Command] = None
    push: bool = False  # push vs pull for parameter tasks
    more: bool = False  # scheduler hint: more blocks coming (ref darlin)
    payload: Any = None  # app-specific (workload descriptors, progress, ...)
    #: wire trace context {flow, node, t_send} (telemetry/spans
    #: trace_context), stamped by Van.transfer so one batch/request stays
    #: ONE flow across the wire. Plain scalars only, validated on decode
    #: (_validate_trace): a hostile blob is rejected loudly, and a header
    #: without the field decodes as None.
    trace: Optional[dict] = None

    def fresh_copy(self) -> "Task":
        """Per-send copy. Filter ``extra`` dicts are per-message side
        channels the encode chain mutates (compression meta, key
        signatures); sharing them across concurrent sends or group
        targets races one send's meta into another's frame."""
        return dataclasses.replace(
            self,
            wait_time=list(self.wait_time),
            filters=[
                dataclasses.replace(f, extra=dict(f.extra))
                for f in self.filters
            ],
        )


@dataclasses.dataclass
class Message:
    """One unit of work/communication (ref message.h Message).

    ``key``/``values`` are host numpy arrays (the localized view of device
    buffers); the device tensors themselves flow through the step the
    executor dispatches.
    """

    task: Task = dataclasses.field(default_factory=Task)
    sender: str = ""
    recver: str = ""
    key: Optional[np.ndarray] = None
    values: List[np.ndarray] = dataclasses.field(default_factory=list)
    callback: Optional[Callable[[], None]] = None

    def __repr__(self) -> str:
        nk = 0 if self.key is None else len(self.key)
        return (
            f"Message({'req' if self.task.request else 'res'} t={self.task.time} "
            f"{self.sender}->{self.recver} keys={nk} vals={len(self.values)})"
        )

    def to_bytes(self) -> bytes:
        """Wire serialization (ref van.cc Van::Send: Task proto followed
        by the key/value SArrays as raw buffers). The task — including
        FilterSpec ``extra`` side-channels like compression meta and key
        signatures — rides pickle, our stand-in for the reference's
        protobuf on a trusted intra-cluster control plane; arrays go as
        raw typed buffers. ``callback`` never crosses the wire."""
        import pickle
        import struct

        arrays = ([] if self.key is None else [self.key]) + list(self.values)
        arrays = [np.ascontiguousarray(a) for a in arrays]
        header = {
            "task": self.task,
            "sender": self.sender,
            "recver": self.recver,
            "has_key": self.key is not None,
            "dtypes": [str(a.dtype) for a in arrays],
            "shapes": [a.shape for a in arrays],
        }
        hb = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
        parts = [struct.pack("<I", len(hb)), hb]
        for a in arrays:
            b = a.tobytes()
            parts.append(struct.pack("<Q", len(b)))
            parts.append(b)
        return b"".join(parts)

    @staticmethod
    def from_bytes(blob: bytes) -> "Message":
        """Inverse of :meth:`to_bytes` (ref van.cc Van::Recv).

        Malformed or truncated frames raise ``ValueError`` (matching the
        codec layer's contract), and the header unpickler is restricted
        to this package's types + numpy reconstruction — a frame from a
        compromised peer cannot name arbitrary callables the way plain
        ``pickle.loads`` would allow."""
        import struct

        try:
            (hlen,) = struct.unpack_from("<I", blob, 0)
            header = _restricted_loads(bytes(blob[4 : 4 + hlen]))
            task = header["task"]
            # trace-context hardening + rolling-upgrade tolerance: a
            # legacy peer's Task pickle predates the field entirely
            # (dataclass unpickling restores __dict__ verbatim, no
            # __init__ defaults) — normalize to None; a present field
            # is narrowed to the closed trace shape or rejected loudly
            task.trace = _validate_trace(getattr(task, "trace", None))
            off = 4 + hlen
            arrays = []
            for dtype, shape in zip(header["dtypes"], header["shapes"]):
                (n,) = struct.unpack_from("<Q", blob, off)
                off += 8
                dt = np.dtype(dtype)
                if off + n > len(blob):
                    raise ValueError("array payload exceeds frame")
                arrays.append(
                    np.frombuffer(blob, dtype=dt, count=n // dt.itemsize,
                                  offset=off).reshape(shape).copy()
                    if n
                    else np.zeros(shape, dt)
                )
                off += n
            key = arrays.pop(0) if header["has_key"] else None
            return Message(
                task=header["task"],
                sender=header["sender"],
                recver=header["recver"],
                key=key,
                values=arrays,
            )
        except ValueError:
            raise
        except Exception as e:  # struct.error, pickle errors, bad shapes...
            raise ValueError(f"truncated or malformed wire frame: {e}") from e


def slice_message(msg: Message, key_ranges: Sequence[Range]) -> List[Message]:
    """Partition an ordered-key message by server key ranges.

    Counterpart of ``Parameter::SliceKOFVMessage`` (parameter.h): for each
    server range, binary-search the key array and emit a sub-message with the
    matching key/value segments.
    """
    out: List[Message] = []
    keys = msg.key if msg.key is not None else np.zeros(0, dtype=np.int64)
    for r in key_ranges:
        lo = int(np.searchsorted(keys, r.begin, side="left"))
        hi = int(np.searchsorted(keys, r.end, side="left"))
        sub = Message(
            task=dataclasses.replace(msg.task, key_range=r),
            sender=msg.sender,
            recver=msg.recver,
            key=keys[lo:hi],
            values=[v.reshape(len(keys), -1)[lo:hi].reshape(-1) for v in msg.values]
            if len(keys)
            else [],
        )
        out.append(sub)
    return out
