"""Van: the transport layer of one process on one card.

Counterpart of ``parameter_server_tpu/system/van.py`` (the reference's
``src/system/van.{h,cc}``). On one card the "wire" between a worker and
its server is the card's own memory, so the Van does two things:

- device placement (``put_table`` / ``put_batch`` / ``put_replicated``)
  of host arrays onto the card, counting the bytes placed — the analog
  of addressing a message to a node group; with one card the three are
  one copy each, named as in the JAX package so callers read the same;
- the host wire (``transfer``): a message framed by ``to_bytes``,
  crossing the ``van.transfer`` fault point, and decoded by
  ``from_bytes``, with the bytes counted on both sides. Given a pair of
  per-peer endpoints (``system/remote_node.py``), the sender's encodes
  and frames the message and the receiver's decodes it, as in the JAX
  package; the aux runtime's metric reports travel so.

Each transfer stamps the sending thread's trace context on the task,
runs inside a ``van.transfer`` span, feeds the nodes' heartbeat traffic
counters and the ``van_*`` instruments. Not here: the multi-process
rendezvous (:func:`init_distributed`, ROADMAP A9).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..telemetry import registry as telemetry_registry
from ..telemetry import spans as telemetry_spans
from . import faults
from .message import Message


class Van:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.placed_bytes = 0  # device placement volume (put_* below)
        # serialized host frames through transfer(), kept apart from the
        # placement bytes so each counter means one thing
        self.wire_sent_bytes = 0
        self.wire_recv_bytes = 0
        # registry mirrors of the counters above (decided here, once)
        self._tel = None
        if telemetry_registry.enabled():
            from ..telemetry.instruments import van_instruments

            self._tel = van_instruments(telemetry_registry.default_registry())
        # ident -> node id, for heartbeat traffic attribution
        self._ident_nodes: dict = {}

    # -- placement (addressing) --

    def _put(self, arr) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr)
        out = t.to(self.device)
        nbytes = t.numel() * t.element_size()
        self.placed_bytes += nbytes
        if self._tel is not None:
            self._tel["placed_bytes"].inc(nbytes)
        return out

    def put_table(self, arr) -> torch.Tensor:
        """Place a parameter table (one server shard: the whole table)."""
        return self._put(arr)

    def put_batch(self, arr) -> torch.Tensor:
        """Place a batch (one worker: the whole batch)."""
        return self._put(arr)

    def put_replicated(self, arr) -> torch.Tensor:
        return self._put(arr)

    # -- host wire (control plane) --

    def transfer(self, *args) -> Message:
        """Frame a message, cross the wire, decode it on the far side (ref
        van.cc Send then Recv): ``transfer(msg)``, or ``transfer(sender,
        recver, msg)`` between two per-peer endpoints, whose chains encode
        and decode it and whose counters see its frame. Sent bytes are
        counted at framing, received bytes only once a frame decodes. The
        ``van.transfer`` fault point sits between the two: ``drop`` raises
        (the frame is lost after its send was counted), ``delay`` sleeps,
        ``duplicate`` decodes the frame twice (at-least-once delivery)."""
        if len(args) == 1:
            (msg,), sender, recver = args, None, None
        else:
            sender, recver, msg = args
        if getattr(msg.task, "trace", None) is None:
            msg.task.trace = telemetry_spans.trace_context()
        blob = msg.to_bytes() if sender is None else sender.to_wire(msg)
        sent = len(blob)
        with telemetry_spans.span("van.transfer", sender=msg.sender, recver=msg.recver,
                                  bytes=sent):
            self.wire_sent_bytes += sent
            self._account(msg.sender, out_bytes=sent)
            fault = faults.check("van.transfer", detail=f"{msg.sender}->{msg.recver}")
            duplicate = False
            if fault is not None:
                if fault.delay_s:
                    time.sleep(fault.delay_s)
                if fault.kind == "drop":
                    raise fault.make_error(f"frame {msg.sender}->{msg.recver} dropped")
                duplicate = fault.kind == "duplicate"
            decode = Message.from_bytes if recver is None else recver.from_wire
            recv = 0
            if duplicate:
                decode(blob)
                recv += len(blob)
            out = decode(blob)
            recv += len(blob)
            self.wire_recv_bytes += recv
            self._account(msg.recver, in_bytes=recv)
            if self._tel is not None:
                self._tel["wire_sent_bytes"].inc(sent)
                self._tel["wire_recv_bytes"].inc(recv)
                self._tel["transfers"].inc()
        return out

    def _account(self, ident: str, in_bytes: int = 0, out_bytes: int = 0) -> None:
        """Feed a transfer's bytes into the node's HeartbeatInfo (the
        dashboard's in(MB)/out(MB) columns). ``ident`` may be a node id
        ("W0") or a customer name, resolved through the manager's
        customer table; skipped before start_aux or for unknown nodes."""
        if not ident or (not in_bytes and not out_bytes):
            return
        from .postoffice import Postoffice

        po = Postoffice._instance  # never create the singleton from here
        if po is None or po.aux is None:
            return
        info = po.aux.info(ident)
        if info is None:
            node_id = self._ident_nodes.get(ident)
            if node_id is None:
                cust = po.manager.find_customer_by_name(ident)
                node = getattr(cust, "node", None)
                if node is None:
                    return  # may register later: no negative caching
                node_id = self._ident_nodes[ident] = node.id
            info = po.aux.info(node_id)
            if info is None:
                return
        if in_bytes:
            info.increase_in_bytes(in_bytes)
        if out_bytes:
            info.increase_out_bytes(out_bytes)


def init_distributed() -> None:
    """Multi-process bootstrap (ref Van::Connect scheduler rendezvous):
    the port runs one process on one card."""
    raise NotImplementedError(
        "a multi-process rendezvous (init_distributed) is not ported: the port runs one "
        "process on one card; the collectives across cards are ROADMAP A9"
    )
