"""SGD learner pieces: the progress record, the scheduler and the
computation-node base, the tail-feature filter and the minibatch reader.

Counterparts of ``SGDProgress``, ``ISGDScheduler``, ``ISGDCompNode``,
``apply_tail_filter`` and ``MinibatchReader`` in the JAX package's
``learner/sgd.py``. ``ISGDScheduler`` holds the workload pool and the
``MonitorMaster`` the workers report to, and prints the merged progress
table (``show_progress``, the JAX scheduler's header and line) once its
``run()`` has set the printer. ``ISGDCompNode`` is the worker-side
plumbing of every SGD-family worker (the linear worker of
``apps/linear/async_sgd.py``, and ``fm.py``, ``deep_ctr.py``):
``collect`` (the wait on a step, the heartbeat and dashboard timers, the
examples counter, the learning plane and consistency hooks, the
per-ministep AUC, the report to a monitor), the default ``train``
window, checkpoints through :class:`~..parameter.replica.Checkpointable`
and the shared ELL prep. The reader
reads and filters on an :class:`~.ingest.IngestPipeline` feeder thread,
as the JAX reader does: the (stateful) filter stays serial, in batch
order, so both yield the same batches in the same order. Files are read
on the chunked byte path (``StreamReader.minibatches_bytes``), parsed by
the native library on a small pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..data.stream_reader import StreamReader
from ..filter.frequency import FrequencyFilter
from ..parameter.replica import Checkpointable
from ..system.customer import App
from ..system.monitor import MonitorMaster, MonitorSlaver
from ..utils.localizer import Localizer
from ..utils.sparse import SparseBatch
from .ingest import IngestPipeline
from .workload_pool import WorkloadPool


@dataclasses.dataclass
class SGDProgress:
    objective: List[float] = dataclasses.field(default_factory=list)
    num_examples_processed: int = 0
    accuracy: List[float] = dataclasses.field(default_factory=list)
    auc: List[float] = dataclasses.field(default_factory=list)
    nnz: int = 0
    weight_sum: float = 0.0
    delta_sum: float = 0.0

    def merge(self, other: "SGDProgress") -> None:
        """Lists extend and counts add; ``nnz`` takes the newer record's
        when it has one (the reference's MergeProgress)."""
        self.objective.extend(other.objective)
        self.accuracy.extend(other.accuracy)
        self.auc.extend(other.auc)
        self.num_examples_processed += other.num_examples_processed
        self.nnz = other.nnz or self.nnz
        self.weight_sum += other.weight_sum
        self.delta_sum += other.delta_sum


class ISGDScheduler(App):
    """Hands workloads to the computation nodes, merges their progress
    and prints the table (ref ISGDScheduler::Run + ShowProgress)."""

    def __init__(self, workload_pool: Optional[WorkloadPool] = None,
                 name: str = "sgd_scheduler"):
        super().__init__(name=name)
        self.workload_pool = workload_pool or WorkloadPool()
        self.monitor: MonitorMaster[SGDProgress] = MonitorMaster()
        self.monitor.set_data_merger(lambda src, dst: dst.merge(src))
        self._show_prog_head = True
        self.num_ex_processed = 0

    def show_progress(self, elapsed: float, progress: Dict[str, SGDProgress]) -> None:
        """One merged line for the window since the last (ref
        ISGDScheduler::ShowProgress); the window's lists are cleared."""
        total = SGDProgress()
        for p in progress.values():
            total.merge(p)
        if not total.objective:
            return
        if self._show_prog_head:
            print(" sec  examples    loss      auc   accuracy")
            self._show_prog_head = False
        self.num_ex_processed += total.num_examples_processed
        # objective entries are a minibatch's sums: print the loss an example
        per_ex = sum(total.objective) / max(1, total.num_examples_processed)
        print(f"{elapsed:4.0f}  {self.num_ex_processed:.2e}  "
              f"{per_ex:.5f}  {np.mean(total.auc or [0]):.4f}  "
              f"{np.mean(total.accuracy or [0]):.4f}", flush=True)
        for p in progress.values():  # the next window starts empty
            p.objective.clear()
            p.auc.clear()
            p.accuracy.clear()
            p.num_examples_processed = 0

    def run(self) -> None:
        self.monitor.set_printer(self.show_progress, interval=1.0)


class ISGDCompNode(App, Checkpointable):
    """Computation-node base of every SGD-family worker (the linear,
    FM and wide&deep workers): steps run on the customer's executor.
    Subclasses set ``self.progress`` (an :class:`SGDProgress`),
    ``self.sgd``, ``self.directory``, ``self.num_slots`` and, for the
    ELL prep, ``self._rows_pad`` (None until the first batch), and
    provide ``process_minibatch`` (returns the step's executor
    timestamp), ``state_host`` and ``load_state_host``. A worker that
    knows its table installs a learning plane (``self._learning``,
    ``telemetry/learning.py``) and, with adaptive τ or the KKT filter, a
    consistency runtime (``self._consistency``,
    ``learner/consistency.py``); :meth:`collect` feeds both."""

    def __init__(self, name: str = "sgd_comp", monitor: Optional[MonitorMaster] = None):
        super().__init__(name=name)
        self.reporter: MonitorSlaver[SGDProgress] = MonitorSlaver(monitor, name)
        # the training volume the device confirmed, counted in collect()
        self._examples_counter = None
        # the learning plane: collect() folds each step's example count
        # and convergence side outputs into it
        self._learning = None
        # adaptive τ / KKT accounting / divergence reaction: collect()
        # hands it each step's metrics after the learning plane folds them
        self._consistency = None
        from ..telemetry import registry as telemetry_registry

        if telemetry_registry.enabled():
            from ..telemetry.instruments import app_instruments

            self._examples_counter = app_instruments(
                telemetry_registry.default_registry())["examples"]

    def attach_monitor(self, scheduler: ISGDScheduler) -> None:
        """Report each collected step to ``scheduler``'s monitor, on the
        collecting thread, once the step's metrics are on the host."""
        self.reporter = MonitorSlaver(scheduler.monitor, self.name)

    def collect(self, ts: int) -> SGDProgress:
        """Wait for step ``ts`` and fold its metrics into ``progress``;
        the wait beats the worker's heartbeat and counts as its busy time
        on the dashboard while the postoffice's aux runtime runs. A T-step
        superbatch's metrics carry a leading ministep axis (``xw`` of
        ``[T, D, R]``): one AUC a ministep, each scored against its own
        weight version."""
        from ..utils import evaluation

        self.po.beat(self.name)
        hb = self.po.aux.info(self.name) if self.po.aux is not None else None
        if hb is not None:
            hb.start_timer()
        metrics = self.executor.wait(ts)
        if hb is not None:
            hb.stop_timer()
        if metrics is None:
            return self.progress
        num_ex = float(metrics["num_ex"])
        if self._examples_counter is not None:
            self._examples_counter.inc(int(num_ex))
        if self._learning is not None:
            self._learning.note_step(metrics)
        if self._consistency is not None:
            # may back off the rate, clamp τ and roll the state back
            self._consistency.on_collect(metrics)
        prog = SGDProgress(
            objective=[float(metrics["objective"])],
            num_examples_processed=int(num_ex),
            accuracy=[float(metrics["correct"]) / max(1.0, num_ex)],
        )
        if "xw" in metrics:  # per-minibatch AUC over the real rows
            y, xw, mask = (metrics[k].cpu().numpy() for k in ("y", "xw", "mask"))
            if xw.ndim >= 3:
                prog.auc = [evaluation.auc(y[t].ravel()[mask[t].ravel() > 0],
                                           xw[t].ravel()[mask[t].ravel() > 0])
                            for t in range(xw.shape[0])]
            else:
                m = mask.ravel() > 0
                prog.auc = [evaluation.auc(y.ravel()[m], xw.ravel()[m])]
        self.progress.merge(prog)
        self.reporter.report(prog)
        return prog

    def train(self, batches) -> SGDProgress:
        """A pass over minibatches with at most two more in flight than
        the one being collected."""
        pending = []
        for b in batches:
            pending.append(self.process_minibatch(b))
            if len(pending) > 2:
                self.collect(pending.pop(0))
        for ts in pending:
            self.collect(ts)
        return self.progress

    def _prep_ell(self, batch: SparseBatch):
        """The ELL prep of the embedding-table workers: rows ceil-divided
        over the data shards (``self.mesh``'s data axis, one without a
        mesh), the row padding fixed by ``SGDConfig.rows_pad`` or the
        first batch, and a larger batch raises."""
        from ..apps.linear.async_sgd import prep_batch_ell  # apps import this module

        mesh = getattr(self, "mesh", None)
        d = 1 if mesh is None else mesh.shape["data"]
        per = -(-batch.n // d)
        if self._rows_pad is None:
            self._rows_pad = self.sgd.rows_pad or per
        if per > self._rows_pad:
            raise ValueError(
                f"batch of {batch.n} rows exceeds the compiled padding "
                f"({self._rows_pad} rows/shard x {d} shards); set "
                "SGDConfig.rows_pad to the largest minibatch up front"
            )
        return prep_batch_ell(batch, self.directory, d, self._rows_pad, self.sgd.ell_lanes,
                              self.num_slots)


def apply_tail_filter(batch: SparseBatch, filter_: FrequencyFilter, freq: int) -> SparseBatch:
    """One batch through the count-min tail-feature filter: insert this
    batch's unique keys with their counts, then drop the entries whose
    estimated frequency is below ``freq``. Stateful: batches must pass
    in stream order. Keys stay global."""
    loc = Localizer()
    keys, cnt = loc.count_uniq_index(batch)
    filter_.insert_keys(keys, cnt)
    keep = filter_.query_keys(keys, freq)
    local = loc.remap_index(keep)
    local.indices = keep[local.indices]
    local.num_cols = batch.num_cols
    return local


class MinibatchReader:
    """Minibatches from files (or a given iterator), through the
    tail-feature filter when one is set, read and filtered on a feeder
    thread behind a bounded queue (``capacity`` batches).

    Lifecycle (enforced): :meth:`init_filter` before :meth:`start`,
    :meth:`start` (idempotent) before reading, no reading after
    :meth:`close`, which joins the feeder. Usable as a context manager."""

    def __init__(
        self,
        files: Optional[List[str]] = None,
        minibatch_size: int = 1000,
        data_format: str = "libsvm",
        capacity: int = 16,
        batches: Optional[Iterator[SparseBatch]] = None,
    ):
        self._source = batches
        if self._source is None:
            # line-aligned byte chunks parsed by the GIL-releasing native
            # parser on two threads (the line path for other formats);
            # the same batches as minibatches()
            self._source = StreamReader(files or [], data_format).minibatches_bytes(
                minibatch_size, threads=2
            )
        self._filter: Optional[FrequencyFilter] = None
        self._freq = 0
        self._capacity = capacity
        self._pipe: Optional[IngestPipeline] = None
        self._it: Optional[Iterator[SparseBatch]] = None
        self._closed = False

    def init_filter(self, n: int, k: int, freq: int) -> None:
        """Count-min tail-feature filter with ``n`` buckets per row and
        ``k`` rows, keeping keys seen at least ``freq`` times."""
        if self._pipe is not None:
            raise RuntimeError("init_filter() after start()")
        self._filter = FrequencyFilter(n, k)
        self._freq = freq

    def start(self) -> "MinibatchReader":
        """Start the feeder thread; a second call does nothing."""
        if self._closed:
            raise RuntimeError("MinibatchReader.start() after close()")
        if self._pipe is not None:
            return self
        filter_fn = None
        if self._filter is not None and self._freq > 0:
            filt, freq = self._filter, self._freq

            def filter_fn(b):
                return apply_tail_filter(b, filt, freq)

        self._pipe = IngestPipeline(self._source, filter_fn=filter_fn,
                                    capacity=self._capacity, name="minibatch_reader").start()
        self._it = iter(self._pipe)
        return self

    def read(self) -> Optional[SparseBatch]:
        """The next minibatch with tail features dropped, or None at the
        end of the stream; re-raises the feeder's exception."""
        if self._pipe is None:
            raise RuntimeError(
                "MinibatchReader.read() before start(): call start() "
                "first, or use the reader as a context manager"
            )
        if self._closed:
            raise RuntimeError("MinibatchReader.read() after close()")
        return next(self._it, None)

    def close(self) -> None:
        """Stop the pipeline and join the feeder; idempotent."""
        self._closed = True
        if self._pipe is not None:
            self._pipe.close()

    def __enter__(self) -> "MinibatchReader":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[SparseBatch]:
        while True:
            b = self.read()
            if b is None:
                return
            yield b
