"""Postoffice: the process-wide system singleton.

Counterpart of ``parameter_server_tpu/system/postoffice.py`` (the
reference's ``src/system/postoffice.{h,cc}``): owns the manager (node
and customer registry) and the van (transport). ``start`` boots the
system: in the JAX package it builds the device mesh; here it picks the
one card (``device``, resolved as every entry point resolves it) and
records one scheduler, one server and one worker node.

One process, one card: ``start(num_server > 1)`` (or ``num_data > 1``)
raises naming ROADMAP A9, the collectives across cards, and
``start_aux`` (heartbeats, dashboard, recovery) raises naming A13.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..device import resolve
from ..utils.range import Range
from .manager import Manager
from .van import Van


class Postoffice:
    _instance: Optional["Postoffice"] = None  # guarded-by: _lock
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.manager = Manager()
        self.device: Optional[torch.device] = None
        self.van: Optional[Van] = None
        self.aux = None
        self._started = False

    @classmethod
    def instance(cls) -> "Postoffice":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Test helper: tear down the singleton (ref Postoffice::Stop).
        The JAX package also resets its telemetry spine here; the port
        has no telemetry spine yet (ROADMAP A12), so there is nothing
        else to reset."""
        with cls._lock:
            cls._instance = None

    def start(self, num_data: Optional[int] = None, num_server: int = 1,
              key_space: Optional[Range] = None, device=None) -> "Postoffice":
        if self._started:
            return self
        if num_server != 1 or (num_data is not None and num_data != 1):
            raise NotImplementedError(
                f"Postoffice.start(num_data={num_data}, num_server={num_server}): the port runs "
                "one server and one worker on one card; more shards need the collectives across "
                "cards (ROADMAP A9)"
            )
        self.device = resolve(device)
        self.van = Van(self.device)
        self.manager.init_nodes(num_servers=1, num_workers=1,
                                key_space=key_space or Range.all())
        self._started = True
        return self

    def start_aux(self, heartbeat_timeout: float = 10.0, print_fn=print):
        raise NotImplementedError(
            "start_aux (heartbeats, the dashboard and node recovery) is not ported "
            "(ROADMAP A13)"
        )

    def beat(self, node_id: str) -> None:
        """Heartbeat passthrough for hot loops; a no-op without start_aux."""

    def stop(self) -> None:
        self.manager.stop()
        self._started = False

    @property
    def started(self) -> bool:
        return self._started
