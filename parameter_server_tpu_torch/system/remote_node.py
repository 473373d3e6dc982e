"""Per-peer state: filter chains and traffic counters.

Counterpart of ``src/system/remote_node.{h,cc}``: the reference keeps one
RemoteNode per (customer, peer) holding the stateful filter instances
(key caches, fixed-point ranges) and byte counters; Van::Send/Recv look the
chain up per peer so caches don't leak across peers. Same structure here
for the host control plane.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..filter.base import FilterChain
from .message import FilterSpec, Message


class RemoteNode:
    def __init__(self, node_id: str):
        self.node_id = node_id
        self.chain = FilterChain()
        self.sent_bytes = 0
        self.recv_bytes = 0
        # serialized frame sizes — the actual on-the-wire counters the
        # reference keeps per peer (remote_node.cc sent_bytes_)
        self.wire_sent_bytes = 0
        self.wire_recv_bytes = 0

    def encode(self, msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> Message:
        out = self.chain.encode(msg, specs)
        self.sent_bytes += sum(v.nbytes for v in out.values)
        return out

    def decode(self, msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> Message:
        self.recv_bytes += sum(v.nbytes for v in msg.values)
        return self.chain.decode(msg, specs)

    def to_wire(self, msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> bytes:
        """Filter-encode then serialize — the full per-peer send path
        (ref van.cc Send: RemoteNode filters, then the ZMQ frame)."""
        blob = self.encode(msg, specs).to_bytes()
        self.wire_sent_bytes += len(blob)
        return blob

    def from_wire(self, blob: bytes) -> Message:
        """Deserialize then filter-decode (ref van.cc Recv)."""
        self.wire_recv_bytes += len(blob)
        return self.decode(Message.from_bytes(blob))


class RemoteNodeTable:
    """node_id → RemoteNode (ref Executor's nodes_ map)."""

    def __init__(self) -> None:
        self._nodes: Dict[str, RemoteNode] = {}

    def get(self, node_id: str) -> RemoteNode:
        if node_id not in self._nodes:
            self._nodes[node_id] = RemoteNode(node_id)
        return self._nodes[node_id]

    def nodes(self) -> list:
        """All per-peer endpoints (for counter aggregation/diagnostics)."""
        return list(self._nodes.values())

    def remove(self, node_id: str) -> None:
        self._nodes.pop(node_id, None)

    def __len__(self) -> int:
        return len(self._nodes)
