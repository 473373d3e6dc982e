"""Neural-net worker trained through KVLayer dense push/pull, on one card.

Counterpart of ``parameter_server_tpu/apps/nn/trainer.py``: the worker
computes the layer gradients and the optimizer applies them (the JAX
step fuses both; with one data shard its ``pmean`` is the identity). The
:class:`~...parameter.kv_layer.KVLayer` stays the parameter store: its
layers are the model's parameter tensors (detached views of the same
storage), so a KVLayer push under its default ``donate=True`` updates
the model, and checkpoints go through ``state_host``.

The JAX default ``optax.sgd(0.05, momentum=0.9)`` is
``torch.optim.SGD(lr=0.05, momentum=0.9)``: both keep the trace
``g + 0.9 * trace`` and apply ``-lr * trace``. The momentum buffers
start as zeros (optax's initial trace), so the first step is that
formula too and the trainer's state has one structure from the start.
:class:`TorchOptimUpdater` is the counterpart of the JAX
``OptaxUpdater`` (a KVLayer updater backed by an optimizer).

On the card the convolutions run in float32 on cuDNN with TF32 off and
its deterministic algorithms (the JAX package's float32 on the CPU is
the reference).

**Over a mesh** (``NNTrainer(..., mesh=...)``, or the started
postoffice's mesh; ``parallel/mesh.py``): every rank builds the model
from the same seed, takes its data row's slice of each batch
(:meth:`shard_batch`), and the gradients are averaged over the data
axis (one ``all_reduce`` of them all, then ``/ D``: the JAX step's
``pmean``), so every rank applies the same update to the same
replicated parameters; the loss and accuracy are averaged the same way.
The KVLayer places each parameter by its rule over the server axis:
its layers are views of the rank's block of each parameter, so a push
to the store updates the model and a pull gathers the whole layer.
Every rank of the mesh calls the same steps on the same global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...device import resolve
from ...models.convnet import cross_entropy
from ...parallel import mesh as meshlib
from ...parameter.kv_layer import KVLayer
from ...parameter.replica import Checkpointable
from ...system.message import Task


def default_optimizer(params) -> torch.optim.Optimizer:
    """The JAX trainer's default, ``optax.sgd(0.05, momentum=0.9)``."""
    return torch.optim.SGD(params, lr=0.05, momentum=0.9)


def _zero_momentum(opt: torch.optim.Optimizer) -> None:
    for group in opt.param_groups:
        if group.get("momentum", 0):
            for p in group["params"]:
                opt.state[p].setdefault("momentum_buffer", torch.zeros_like(p))


class TorchOptimUpdater:
    """KVLayer updater backed by a ``torch.optim`` optimizer (``make``:
    params -> optimizer). ``update`` runs one step of a fresh optimizer
    on a copy of the layer, as the JAX ``OptaxUpdater`` runs ``tx.update``
    from a fresh ``tx.init``."""

    def __init__(self, make: Callable = default_optimizer):
        self.make = make

    def init(self, name, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=device)

    def update(self, name, weight: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        p = weight.detach().clone().requires_grad_()
        p.grad = recv.to(p.dtype)
        opt = self.make([p])
        _zero_momentum(opt)
        opt.step()
        return p.detach()


def _cudnn_f32():
    """cuDNN in float32 (no TF32) with its deterministic algorithms."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


class NNTrainer(Checkpointable):
    """``model`` (a :class:`~...models.convnet.ConvNet` or ``MLP``, built
    here for ``input_shape`` from ``seed``) trained on ``device`` (the
    started postoffice's, else the card; raises without one), or over
    ``mesh`` (default: the started postoffice's)."""

    def __init__(self, model, input_shape: Tuple[int, ...], optimizer: Optional[Callable] = None,
                 partition_thr: int = 100_000, loss_fn: Callable = cross_entropy, seed: int = 0,
                 device=None, mesh=None):
        from ...system.postoffice import Postoffice

        po = Postoffice._instance
        if mesh is None and po is not None and po.started:
            mesh = po.mesh
        if mesh is not None and mesh.size == 1:
            mesh = None  # one card: the pmean is the identity
        #: the mesh the batch and the layers are placed over (None: one card)
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        elif device is None and po is not None and po.started:
            device = po.device
        self.device = resolve(device)
        self.model = model.init(seed, tuple(input_shape), self.device)
        self.loss_fn = loss_fn
        self.kv = KVLayer(partition_thr=partition_thr, name="nn_layers", device=self.device,
                          mesh=mesh)
        self._params = dict(sorted(self.model.named_parameters()))
        for key, p in self._params.items():
            self.kv.place(key, p.detach())
        self.opt = (optimizer or default_optimizer)(list(self._params.values()))
        _zero_momentum(self.opt)
        self.steps_done = 0

    def _pack(self) -> None:
        """Drain the KVLayer's pushes, and take into the model any layer
        the store installed anew (``set_replica``, a non-donating push)."""
        self.kv.executor.wait_all(pop=False)
        with torch.no_grad():
            for key, p in self._params.items():
                layer, mine = self.kv.layers[key], self.kv.block(key, p.detach())
                if layer.data_ptr() != mine.data_ptr():
                    mine.copy_(layer)
                    self.kv.place(key, p.detach())

    def state_host(self) -> dict:
        """Host snapshot: ``params`` (name -> array), ``opt`` (name ->
        the optimizer's tensors for that parameter) and ``steps_done``."""
        self._pack()
        params = {k: p.detach().cpu().numpy().copy() for k, p in self._params.items()}
        opt = {k: {n: v.detach().cpu().numpy().copy() for n, v in sorted(self.opt.state[p].items())
                   if isinstance(v, torch.Tensor)}
               for k, p in self._params.items()}
        return {"params": params, "opt": opt, "steps_done": np.int64(self.steps_done)}

    def load_state_host(self, snap: dict) -> None:
        self._pack()
        with torch.no_grad():
            for k, p in self._params.items():
                p.copy_(torch.as_tensor(np.asarray(snap["params"][k])))
                for n, v in snap["opt"].get(k, {}).items():
                    self.opt.state[p][n] = torch.as_tensor(np.array(v)).to(self.device)
        self.steps_done = int(snap["steps_done"])

    def shard_batch(self, x: np.ndarray, y: np.ndarray):
        """This rank's data row of the batch on the device: the whole
        batch on one card, else its ``n / D`` rows (``n`` must divide by
        the data axis ``D``, as in the JAX trainer)."""
        if self.mesh is not None:
            d, n = meshlib.num_workers(self.mesh), len(y)
            per = n // d
            if per * d != n:
                raise ValueError(f"batch {n} not divisible by {d} workers")
            i = self.mesh.data_index
            x, y = x[i * per:(i + 1) * per], y[i * per:(i + 1) * per]
        return (torch.as_tensor(np.asarray(x, np.float32)).to(self.device),
                torch.as_tensor(np.asarray(y, np.int64)).to(self.device))

    def _pmean(self, tensors) -> None:
        """Average ``tensors`` in place over the data axis (one flat
        ``all_reduce``, then ``/ D``); nothing on one data row."""
        if self.mesh is None or meshlib.num_workers(self.mesh) == 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = meshlib.psum(flat, meshlib.DATA_AXIS, self.mesh) / meshlib.num_workers(self.mesh)
        lo = 0
        for t in tensors:
            t.copy_(flat[lo:lo + t.numel()].view_as(t))
            lo += t.numel()

    def train_step(self, x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
        xs, ys = self.shard_batch(x, y)
        self._pack()
        with _cudnn_f32():
            logits = self.model(xs)
            loss = self.loss_fn(logits, ys)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            params = list(self._params.values())
            self._pmean([p.grad for p in params])
            self.opt.step()
        acc = torch.mean((torch.argmax(logits.detach(), -1) == ys).to(torch.float32))
        metrics = torch.stack([loss.detach(), acc])
        self._pmean([metrics])
        self.steps_done += 1
        return {"loss": float(metrics[0]), "accuracy": float(metrics[1])}

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
        """Loss and accuracy on the whole batch (every rank alike)."""
        xs = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        ys = torch.as_tensor(np.asarray(y, np.int64)).to(self.device)
        self._pack()
        with torch.no_grad(), _cudnn_f32():
            logits = self.model(xs)
            acc = float(torch.mean((torch.argmax(logits, -1) == ys).to(torch.float32)))
            return {"accuracy": acc, "loss": float(self.loss_fn(logits, ys))}

    # -- the KVLayer's API, passed through --

    def push(self, key, grad, task: Optional[Task] = None) -> int:
        return self.kv.push(task or self.kv.request(), key, grad)

    def pull(self, key, task: Optional[Task] = None) -> torch.Tensor:
        return self.kv.wait_pull(self.kv.pull(task or self.kv.request(), key))

    def push_pull(self, key, grad, task: Optional[Task] = None) -> torch.Tensor:
        """A gradient push and the updated layer back in one step."""
        return self.kv.wait_pull(self.kv.push_pull(task or self.kv.request(), key, grad))
