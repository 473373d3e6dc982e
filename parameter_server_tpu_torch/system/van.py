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
  ``from_bytes``, with the bytes counted on both sides.

Not here: the per-peer filter chains (the JAX package's ``RemoteNode``)
that encode a message on its way (ROADMAP A13), and the multi-process
rendezvous (:func:`init_distributed`, ROADMAP A9).
"""

from __future__ import annotations

import time

import numpy as np
import torch

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

    # -- placement (addressing) --

    def _put(self, arr) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr)
        out = t.to(self.device)
        self.placed_bytes += t.numel() * t.element_size()
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

    def transfer(self, msg: Message) -> Message:
        """Frame ``msg``, cross the wire, decode it on the far side (ref
        van.cc Send then Recv). Sent bytes are counted at framing,
        received bytes only once a frame decodes. The ``van.transfer``
        fault point sits between the two: ``drop`` raises (the frame is
        lost after its send was counted), ``delay`` sleeps, ``duplicate``
        decodes the frame twice (at-least-once delivery)."""
        blob = msg.to_bytes()
        self.wire_sent_bytes += len(blob)
        fault = faults.check("van.transfer", detail=f"{msg.sender}->{msg.recver}")
        duplicate = False
        if fault is not None:
            if fault.delay_s:
                time.sleep(fault.delay_s)
            if fault.kind == "drop":
                raise fault.make_error(f"frame {msg.sender}->{msg.recver} dropped")
            duplicate = fault.kind == "duplicate"
        if duplicate:
            Message.from_bytes(blob)
            self.wire_recv_bytes += len(blob)
        out = Message.from_bytes(blob)
        self.wire_recv_bytes += len(blob)
        return out


def init_distributed() -> None:
    """Multi-process bootstrap (ref Van::Connect scheduler rendezvous):
    the port runs one process on one card."""
    raise NotImplementedError(
        "a multi-process rendezvous (init_distributed) is not ported: the port runs one "
        "process on one card; the collectives across cards are ROADMAP A9"
    )
