"""KVLayer: named dense parameter blobs for neural-net workers, on one card.

Counterpart of ``parameter_server_tpu/parameter/kv_layer.py`` (the
reference's ``src/parameter/kv_layer.h``): layers are keyed by an int or
a name and pushed and pulled whole; a push runs the store's ``Updater``
(``update(name, weight, recv) -> weight'``) on the server side. Pushes
and pulls are steps of the store's executor, in timestamp order.

One card holds every layer whole. **Over a mesh** (``KVLayer(mesh=...)``,
or the started postoffice's mesh; ``parallel/mesh.py``) the placement is
the JAX store's, ``partition.layer_sharding(shape, partition_thr)``: a
layer of at least ``partition_thr`` elements is cut on its first
dimension that divides by the server count, one block a server rank
(every data rank of a server column holds the same block); a smaller
one is whole on every rank. A push takes the whole gradient (every rank
the same) and runs the updater on the rank's block (the updaters here
are elementwise, so the blocks of an update are the update of the
whole); a pull gathers the whole layer over the server group, a
collective on the store's executor in step order. Every rank makes the
same pushes and pulls in the same order. ``layers`` holds each rank's
blocks; ``get_replica`` / ``set_replica`` take and give whole layers.

**Donation contract.** With ``donate=True`` (the default) the store owns
its layer tensors and a push writes the updated weight into the layer's
tensor in place: a layer pulled before the push is that tensor, and
reads the update (the JAX store donates the buffer instead, so there a
stale pulled view raises; a pull of a layer cut over server shards is
a gathered copy). Callers that hold weights across pushes copy
them; ``get_replica`` copies to the host. With ``donate=False`` a push
installs a new tensor, and a pull taken before it keeps its values.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..parallel import mesh as meshlib
from ..parallel import partition as partlib
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
    raises without one), or over ``mesh`` (default: the started
    postoffice's) with the placement of the module's docstring."""

    def __init__(self, partition_thr: int = 1000, updater=None, donate: bool = True,
                 id: Optional[int] = None, name: str = "", device=None, mesh=None):
        super().__init__(id=id, name=name)
        if mesh is None and self.po.started:
            mesh = self.po.mesh
        if mesh is not None and mesh.size == 1:
            mesh = None  # one card: every layer whole, every collective the identity
        #: the mesh the layers are placed over (None: one card)
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        elif device is None and self.po.started:
            device = self.po.device
        self.device = resolve(device)
        self.partition_thr = int(partition_thr)
        self.updater = updater or SGDUpdater()
        self.donate = bool(donate)
        self.partitioner = None if mesh is None else partlib.for_mesh(mesh)
        #: this rank's block of each layer (the whole layer where it is not cut)
        self.layers: Dict[object, torch.Tensor] = {}
        #: each layer's whole shape and the dim cut over the server axis (None: whole)
        self._placed: Dict[object, Tuple[Tuple[int, ...], Optional[int]]] = {}

    def sharded_dim(self, shape) -> Optional[int]:
        """The dim a layer of ``shape`` is cut on over the server axis, or
        None where it is whole on every rank (the placement rule)."""
        if self.partitioner is None:
            return None
        spec = self.partitioner.layer_sharding(tuple(shape), self.partition_thr).spec
        cut = [d for d, axis in enumerate(spec) if axis == meshlib.SERVER_AXIS]
        return cut[0] if cut and meshlib.num_servers(self.mesh) > 1 else None

    def block(self, key, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole-layer tensor (a view)."""
        dim = self._placed[key][1] if key in self._placed else self.sharded_dim(whole.shape)
        if dim is None:
            return whole
        n = meshlib.num_servers(self.mesh)
        size = whole.shape[dim] // n
        return whole.narrow(dim, self.mesh.server_index * size, size)

    def place(self, key, whole: torch.Tensor) -> torch.Tensor:
        """Install this rank's block of the whole layer ``whole`` (a view
        of it: a caller that keeps ``whole`` shares the block's storage)."""
        self._placed[key] = (tuple(whole.shape), self.sharded_dim(whole.shape))
        self.layers[key] = self.block(key, whole)
        return self.layers[key]

    def init_layer(self, key, shape, dtype=torch.float32) -> torch.Tensor:
        """The updater's init of the whole layer, this rank's block kept
        (a copy: the same draw the one card makes, cut)."""
        return self._init_block(key, self.updater.init(key, tuple(shape), dtype, self.device))

    def _init_block(self, key, whole: torch.Tensor) -> torch.Tensor:
        """Install this rank's block of a fresh whole tensor, as its own copy."""
        block = self.place(key, whole)
        if block.shape != whole.shape:
            self.layers[key] = block.clone()
        return self.layers[key]

    def __getitem__(self, key) -> torch.Tensor:
        return self.layers[key]

    def layer(self, key) -> torch.Tensor:
        """This rank's block of the layer (the whole layer on one card)."""
        return self.layers[key]

    def _whole(self, key, side: bool = False) -> torch.Tensor:
        """The whole layer from every server rank's block (a collective of
        the server group; ``side``: its side group, off the executor)."""
        dim = self._placed.get(key, (None, None))[1]
        block = self.layers[key]
        if dim is None:
            return block
        mesh = self.mesh.side if side else self.mesh
        moved = block.movedim(dim, 0).contiguous()
        return meshlib.all_gather(moved, meshlib.SERVER_AXIS, mesh).movedim(0, dim)

    def _recv(self, data) -> torch.Tensor:
        t = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
        if t.dtype == torch.float64:  # as jnp.asarray under JAX's default 32-bit mode
            t = t.to(torch.float32)
        return t.to(self.device)

    def _push_step(self, key, data, pull: bool = False):
        """The update step that push and push_pull submit: receive (a layer
        not seen before starts from the updater's init), run the updater
        on this rank's block, install the result (in place under
        ``donate``); ``pull``: the whole layer back."""
        recv = self._recv(data)
        self._ensure(key, recv)
        recv = self.block(key, recv)

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
            return self._whole(key) if pull else self.layers[key]

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
            return self._whole(key)

        return self.instrumented_submit("pull", key, 1, step, task, callback)

    def push_pull(self, task: Task, key, data, callback=None) -> int:
        """A push and the updated layer back in one step (result via
        :meth:`wait_pull`); the same bits as ``push`` then ``pull``."""
        return self.instrumented_submit("push_pull", key, 1, self._push_step(key, data, True),
                                        task, callback)

    def wait_pull(self, ts: int) -> torch.Tensor:
        return self.executor.wait(ts)

    def get_replica(self) -> dict:
        """Host copies of every whole layer once the steps in flight are
        done (on a mesh every rank calls it: a gather of the cut layers)."""
        self.executor.wait_all(pop=False)
        return {k: self._whole(k, side=True).detach().cpu().numpy().copy()
                for k in self.layers}

    def set_replica(self, snapshot: dict) -> None:
        """Install whole layers (copies); on a mesh each rank keeps its block."""
        for k, arr in snapshot.items():
            self._init_block(k, self._recv(arr).clone())
