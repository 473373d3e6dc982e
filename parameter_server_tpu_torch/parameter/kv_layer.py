"""KVLayer: named dense parameter blobs for neural-net workers, on one card.

Counterpart of ``parameter_server_tpu/parameter/kv_layer.py`` (the
reference's ``src/parameter/kv_layer.h``): layers are keyed by an int or
a name and pushed and pulled whole; a push runs the store's ``Updater``
(``update(name, weight, recv) -> weight'``) on the server side. Pushes
and pulls are steps of the store's executor, in timestamp order.

One card holds every layer whole. ``partition_thr`` is kept and recorded
(the JAX store shards a layer of at least that many elements over the
server axis; splitting layers over server shards is ROADMAP A9).

**Donation contract.** With ``donate=True`` (the default) the store owns
its layer tensors and a push writes the updated weight into the layer's
tensor in place: a layer pulled before the push is that tensor, and
reads the update (the JAX store donates the buffer instead, so there a
stale pulled view raises). Callers that hold weights across pushes copy
them; ``get_replica`` copies to the host. With ``donate=False`` a push
installs a new tensor, and a pull taken before it keeps its values.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve
from ..system.message import Task
from .parameter import Parameter


class SGDUpdater:
    """Default updater: ``w - lr * grad``."""

    def __init__(self, lr: float = 0.01):
        self.lr = lr

    def init(self, name, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    def update(self, name, weight: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        return weight - self.lr * recv


class KVLayer(Parameter):
    """Layers on ``device`` (the started postoffice's, else the card;
    raises without one)."""

    def __init__(self, partition_thr: int = 1000, updater=None, donate: bool = True,
                 id: Optional[int] = None, name: str = "", device=None):
        super().__init__(id=id, name=name)
        if device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        self.partition_thr = int(partition_thr)
        self.updater = updater or SGDUpdater()
        self.donate = bool(donate)
        self.layers: Dict[object, torch.Tensor] = {}

    def init_layer(self, key, shape, dtype=torch.float32) -> torch.Tensor:
        self.layers[key] = self.updater.init(key, tuple(shape), dtype, self.device)
        return self.layers[key]

    def __getitem__(self, key) -> torch.Tensor:
        return self.layers[key]

    def layer(self, key) -> torch.Tensor:
        return self.layers[key]

    def _recv(self, data) -> torch.Tensor:
        t = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
        if t.dtype == torch.float64:  # as jnp.asarray under JAX's default 32-bit mode
            t = t.to(torch.float32)
        return t.to(self.device)

    def _push_step(self, key, data):
        """The update step that push and push_pull submit: receive (a layer
        not seen before starts from the updater's init), run the updater,
        install the result (in place under ``donate``)."""
        recv = self._recv(data)
        self._ensure(key, recv)

        def step():
            new = self.updater.update(key, self.layers[key], recv)
            if self.donate:
                from ..telemetry.instruments import cached_kvops_instruments

                tel = cached_kvops_instruments()
                if tel is not None:
                    tel["donated_pushes"].inc()
                self.layers[key].copy_(new)
            else:
                self.layers[key] = new
            return self.layers[key]

        return step

    def _ensure(self, key, recv: torch.Tensor) -> None:
        if key not in self.layers:
            self.init_layer(key, tuple(recv.shape), recv.dtype)

    def push(self, task: Task, key, data, callback=None) -> int:
        """Push a gradient (or update) for a layer; the updater runs on
        the store's side."""
        return self.instrumented_submit("push", key, 1, self._push_step(key, data), task,
                                        callback)

    def pull(self, task: Task, key, callback=None) -> int:
        """Pull the layer; under ``donate`` the result is the live layer
        tensor (module docstring)."""

        def step():
            return self.layers[key]

        return self.instrumented_submit("pull", key, 1, step, task, callback)

    def push_pull(self, task: Task, key, data, callback=None) -> int:
        """A push and the updated layer back in one step (result via
        :meth:`wait_pull`); the same bits as ``push`` then ``pull``."""
        return self.instrumented_submit("push_pull", key, 1, self._push_step(key, data), task,
                                        callback)

    def wait_pull(self, ts: int) -> torch.Tensor:
        return self.executor.wait(ts)

    def get_replica(self) -> dict:
        """Host copies of every layer once the steps in flight are done."""
        self.executor.wait_all(pop=False)
        return {k: v.detach().cpu().numpy().copy() for k, v in self.layers.items()}

    def set_replica(self, snapshot: dict) -> None:
        for k, arr in snapshot.items():
            self.layers[k] = self._recv(arr).clone()
