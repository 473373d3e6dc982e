"""Score a saved linear model on validation data, on the device.

Counterpart of ``parameter_server_tpu/apps/linear/model_evaluation.py``
(the reference's ``model_evaluation``), an :class:`~...system.customer.App`
as there (``App.create`` returns it for a conf with validation data and
no training section): load a text model
(``key\\tweight`` lines, possibly several shard files), stream the
validation data and print its AUC, accuracy and log loss.

- Model load, on the host, as the JAX package does it: files in
  ``expand_globs`` order, a later file's key wins, each weight parsed
  with ``float()`` and the array then cast to float32. A ``#hashed
  <num_slots>`` header (the training worker's hashed export) means the
  keys are table slots, and validation keys are hashed the same way.
- Scoring, on the device: the model is installed once, as sorted int64
  keys with float32 weights (looked up with ``torch.searchsorted``) or,
  hashed, as a ``[num_slots]`` float32 table (a gather; a missing slot
  reads 0.0, as the key lookup's miss does). Each minibatch of 1 << 14
  rows is read by ``StreamReader``, its keys hashed on the host
  (``hash_slots``), and on the device each entry's weight is looked up,
  multiplied by its value and summed by row with
  ``ops/segment_sum.segment_sum(..., presorted=True)``: CSR rows are
  grouped, so on the card that is one ``segment_sum.cu`` launch a
  minibatch.
- Metrics, on the host, from y and Xw (``utils/evaluation.py``).
- On a mesh of ranks: one evaluation, as the JAX CLI runs one whatever
  its mesh; the linear CLI runs it on rank 0 (``main.py``), which prints
  what one card prints.

Each row's sum adds its entries in entry order from +0.0, as the JAX
package's ``np.add.at`` into float32 zeros does, so Xw and the metrics
are bit-equal with it, on the CPU and on the card. Keys written as
unsigned integers of 2^63 and above are taken as their int64 view, the
form the parsers give such keys (the JAX package raises on them).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...data.stream_reader import StreamReader
from ...device import resolve
from ...ops.segment_sum import segment_sum
from ...system.customer import App
from ...utils import evaluation
from ...utils import file as psfile
from ...utils.murmur import hash_slots
from ...utils.sparse import SparseBatch
from .config import Config

MINIBATCH = 1 << 14
_U64 = 1 << 64


class ModelEvaluation(App):
    def __init__(self, conf: Config, device=None, name: str = "model_evaluation"):
        super().__init__(name=name)
        self.conf = conf
        self.device = resolve(device)
        self.hashed_slots = 0
        self.metrics: Dict[str, float] = {}

    def load_model(self) -> Dict[int, float]:
        """The model's ``{key: weight}``; sets ``hashed_slots`` from a
        ``#hashed`` header."""
        if self.conf.model_input is None:
            raise ValueError("model evaluation needs model_input")
        weight: Dict[int, float] = {}
        self.hashed_slots = 0
        for path in psfile.expand_globs(self.conf.model_input.file):
            with psfile.open_read(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    if parts[0] == "#hashed":
                        self.hashed_slots = int(parts[1])
                        continue
                    if len(parts) >= 2:
                        key = int(parts[0]) % _U64
                        weight[key - _U64 if key >> 63 else key] = float(parts[1])
        return weight

    def install(self, weight: Dict[int, float]) -> None:
        """Put the model on the device: sorted keys and their weights, or
        the hashed table."""
        keys = np.fromiter(weight.keys(), dtype=np.int64, count=len(weight))
        vals = np.fromiter(weight.values(), dtype=np.float32, count=len(weight))
        order = np.argsort(keys)
        keys, vals = keys[order], vals[order]
        self.num_weights = len(keys)
        if self.hashed_slots:
            inside = (keys >= 0) & (keys < self.hashed_slots)
            table = torch.zeros(self.hashed_slots, dtype=torch.float32, device=self.device)
            table[torch.from_numpy(keys[inside]).to(self.device)] = (
                torch.from_numpy(vals[inside]).to(self.device))
            self.table = table
        else:
            self.keys = torch.from_numpy(keys).to(self.device)
            self.vals = torch.from_numpy(vals).to(self.device)

    def lookup(self, batch: SparseBatch) -> np.ndarray:
        """What the host hands the device for ``batch``: its keys, or
        their slots in the hashed table."""
        if self.hashed_slots:
            return hash_slots(batch.indices, self.hashed_slots)
        return batch.indices

    def xw(self, batch: SparseBatch, lookup: np.ndarray) -> torch.Tensor:
        """``[batch.n]`` float32 margins on the device: each row's
        ``value * weight`` summed in entry order from +0.0."""
        dev = self.device
        if not self.num_weights or not batch.nnz:
            return torch.zeros(batch.n, dtype=torch.float32, device=dev)
        ids = torch.from_numpy(lookup).to(dev)
        if self.hashed_slots:
            w = self.table.index_select(0, ids)
        else:
            pos = torch.searchsorted(self.keys, ids)
            posc = pos.clamp_max(self.num_weights - 1)
            hit = (pos < self.num_weights) & (self.keys[posc] == ids)
            w = torch.where(hit, self.vals[posc], torch.zeros((), device=dev))
        if not batch.binary:  # a binary entry's value is 1.0: 1.0 * w is w
            w = w * torch.from_numpy(batch.values).to(dev)
        counts = torch.from_numpy(np.diff(batch.indptr)).to(dev)
        rows = torch.repeat_interleave(
            torch.arange(batch.n, dtype=torch.int64, device=dev), counts, output_size=batch.nnz)
        return segment_sum(w, rows, batch.n, presorted=True)

    def run(self) -> Dict[str, float]:
        """Load, score every validation minibatch, print and return the
        metrics (``num_examples``, ``auc``, ``accuracy``, ``logloss``)."""
        self.install(self.load_model())
        vd = self.conf.validation_data
        if vd is None:
            raise ValueError("model evaluation needs validation_data")
        reader = StreamReader(vd.file, vd.text if vd.format == "text" else vd.format)
        ys: List[np.ndarray] = []
        xws: List[torch.Tensor] = []
        for batch in reader.minibatches_bytes(MINIBATCH, threads=2):
            xws.append(self.xw(batch, self.lookup(batch)))
            ys.append(batch.y)
        y = np.concatenate(ys) if ys else np.zeros(0, np.float32)
        xw = torch.cat(xws).cpu().numpy() if xws else np.zeros(0, np.float32)
        self.margins = xw
        self.metrics = {
            "num_examples": float(len(y)),
            "auc": evaluation.auc(y, xw),
            "accuracy": evaluation.accuracy(y, xw),
            "logloss": evaluation.logloss(y, xw),
        }
        print(
            f"auc: {self.metrics['auc']:.6f}, accuracy: {self.metrics['accuracy']:.6f}, "
            f"logloss: {self.metrics['logloss']:.6f} ({int(self.metrics['num_examples'])} examples)"
        )
        return self.metrics
