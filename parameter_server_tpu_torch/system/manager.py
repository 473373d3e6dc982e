"""Manager: customer registry and node lifecycle.

Counterpart of ``parameter_server_tpu/system/manager.py`` (the
reference's ``src/system/manager.{h,cc}``), whole: tracks customers by
id, assigns fresh customer ids (ref ``NextCustomerID``), records node
roles and key ranges, broadcasts node add/remove events to subscribers
(ref ``AddNode``'s NodeChange broadcast / ``NodeDisconnected``), and
coordinates orderly shutdown. The node table follows the postoffice's
mesh (its server and worker counts); ``system/elastic.py``'s coordinator
rebuilds it at each resize and broadcasts the membership diff, on every
rank of the world alike.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils.range import Range


class Node:
    """A logical node (ref proto/node.proto): role + key range."""

    SCHEDULER, SERVER, WORKER = "scheduler", "server", "worker"

    def __init__(self, role: str, rank: int, key_range: Optional[Range] = None):
        self.role = role
        self.rank = rank
        self.key_range = key_range if key_range is not None else Range.all()
        # H=scheduler(head), S=server, W=worker — distinct prefixes (the
        # reference's van.cc uses "H" for the scheduler node id too)
        prefix = {"scheduler": "H", "server": "S", "worker": "W"}[role]
        self.id = f"{prefix}{rank}"

    def __repr__(self) -> str:
        return f"Node({self.id}, keys={self.key_range})"


class Manager:
    def __init__(self) -> None:
        self._customers: Dict[int, object] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self.nodes: List[Node] = []
        # (event, node) listeners; event in {"add", "remove"} (ref
        # manager.cc NodeChange broadcast to every connected node)
        self._node_listeners: List = []

    def subscribe_nodes(self, cb) -> None:
        """Register a callback for node add/remove events (idempotent —
        elastic resizes re-subscribe surviving listeners)."""
        if cb not in self._node_listeners:
            self._node_listeners.append(cb)

    def broadcast(self, event: str, node: Node) -> None:
        """Fan a membership event out to subscribers (ref manager.cc
        NodeChange broadcast). ``event`` in {"add", "remove"}."""
        for cb in list(self._node_listeners):
            cb(event, node)

    def add_node(self, node: Node) -> None:
        """Record a joined node and broadcast (ref manager.cc AddNode)."""
        with self._lock:
            self.nodes.append(node)
        self.broadcast("add", node)

    def remove_node(self, node_id: str) -> Optional[Node]:
        """Drop a node and broadcast (ref manager.cc NodeDisconnected)."""
        with self._lock:
            for i, n in enumerate(self.nodes):
                if n.id == node_id:
                    dead = self.nodes.pop(i)
                    break
            else:
                return None
        self.broadcast("remove", dead)
        return dead

    def next_customer_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def add_customer(self, customer) -> None:
        with self._lock:
            if customer.id in self._customers:
                raise ValueError(f"customer id {customer.id} already exists")
            self._customers[customer.id] = customer

    def remove_customer(self, cid: int) -> None:
        with self._lock:
            self._customers.pop(cid, None)

    def get_customer(self, cid: int):
        with self._lock:
            return self._customers.get(cid)

    def find_customer_by_name(self, name: str):
        with self._lock:
            for c in self._customers.values():
                if getattr(c, "name", None) == name:
                    return c
        return None

    def init_nodes(self, num_servers: int, num_workers: int, key_space: Range) -> None:
        """Assign server key ranges by even division (ref manager.cc
        NodeIDGenerator / Range::EvenDivide over servers)."""
        self.nodes = [Node(Node.SCHEDULER, 0)]
        for i in range(num_servers):
            self.nodes.append(Node(Node.SERVER, i, key_space.even_divide(num_servers, i)))
        for i in range(num_workers):
            self.nodes.append(Node(Node.WORKER, i))

    def stop(self) -> None:
        with self._lock:
            self._customers.clear()
