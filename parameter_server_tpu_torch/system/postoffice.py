"""Postoffice: the process-wide system singleton.

Counterpart of ``parameter_server_tpu/system/postoffice.py`` (the
reference's ``src/system/postoffice.{h,cc}``): owns the manager (node
and customer registry) and the van (transport). ``start`` boots the
system: it joins the world a launcher names (``van.init_distributed``),
builds this rank's ``(data, server)`` mesh over it
(``parallel/mesh.make_mesh``, the JAX package's auto-shape rules: one
process alone is a ``1 x 1`` mesh on its card) and records the
scheduler, the mesh's server nodes and its worker nodes. ``device`` is
the rank's card (resolved as every entry point resolves it; in a world,
``distributed.rank_device`` by default). In a world the postoffice can be
stopped, reset and started again on another shape (an elastic resize,
``system/elastic.py``): the world stays, and the new mesh's groups are
made over a prefix of it by every rank. ``start_aux``
creates the heartbeat / metrics-plane / dashboard / recovery runtime
(``system/aux_runtime.py``), and ``metrics`` is the process telemetry
registry every layer records into.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..device import resolve
from ..telemetry import registry as telemetry_registry
from ..telemetry import spans as telemetry_spans
from ..utils.range import Range
from .manager import Manager
from .van import Van, init_distributed


class Postoffice:
    _instance: Optional["Postoffice"] = None  # guarded-by: _lock
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.manager = Manager()
        self.device: Optional[torch.device] = None
        self.van: Optional[Van] = None
        self.mesh = None  # this rank's parallel.mesh.Mesh once started
        self.aux = None  # AuxRuntime once start_aux() is called
        # the process telemetry spine: every layer's instruments register
        # here; reset() swaps in a fresh registry
        self.metrics = telemetry_registry.default_registry()
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
        Also resets the telemetry spine (a fresh default registry, the
        span sink closed, a fresh history store, the learning planes and
        the device inventory dropped), so metrics never leak across
        hermetic tests."""
        with cls._lock:
            inst, cls._instance = cls._instance, None
        if inst is not None and inst.aux is not None:
            inst.aux.stop()
        telemetry_registry.reset_default_registry()
        telemetry_spans.close_sink()
        from ..telemetry import device as telemetry_device
        from ..telemetry import history as telemetry_history
        from ..telemetry import learning as telemetry_learning

        telemetry_history.reset_default_store()
        telemetry_learning.reset()
        telemetry_device.reset()

    def start(self, num_data: Optional[int] = None, num_server: int = 1,
              key_space: Optional[Range] = None, device=None) -> "Postoffice":
        if self._started:
            return self
        from ..parallel import distributed
        from ..parallel import mesh as meshlib

        if init_distributed() and device is None:
            device = distributed.rank_device()
        self.device = resolve(device)
        self.mesh = meshlib.make_mesh(num_data=num_data, num_server=num_server,
                                      device=self.device)
        self.van = Van(self.device)
        self.manager.init_nodes(num_servers=meshlib.num_servers(self.mesh),
                                num_workers=meshlib.num_workers(self.mesh),
                                key_space=key_space or Range.all())
        self._started = True
        return self

    def start_aux(self, heartbeat_timeout: float = 10.0, print_fn=print):
        """Create (once) the heartbeat / dashboard / recovery runtime (the
        reference's postoffice.cc heartbeat thread, manager.cc dead-node
        flow and dashboard.cc)."""
        if self.aux is None:
            from .aux_runtime import AuxRuntime

            self.aux = AuxRuntime(heartbeat_timeout=heartbeat_timeout, print_fn=print_fn)
        return self.aux

    def beat(self, node_id: str) -> None:
        """Heartbeat passthrough for hot loops; a no-op before start_aux."""
        if self.aux is not None:
            self.aux.beat(node_id)

    def stop(self) -> None:
        if self.aux is not None:
            self.aux.stop()
            self.aux = None
        self.manager.stop()
        self._started = False

    @property
    def started(self) -> bool:
        return self._started
