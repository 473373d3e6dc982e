"""Linear-method CLI: train the model a reference-style ``.conf`` selects.

    python -m parameter_server_tpu_torch.apps.linear.main <config.conf> [--device cpu]

Counterpart of ``parameter_server_tpu/apps/linear/main.py`` for the
``async_sgd`` app and model evaluation, on one device (the CUDA device
unless ``--device`` names another).

- ``async_sgd``: each ``training_data`` file pattern is one workload a
  pass, for ``num_data_pass`` passes; a workload is read, parsed and
  passed through a fresh count-min tail filter on the reader's feeder
  thread, and trained on (``AsyncSGDWorker.train``). Then the model is
  written to ``model_output`` and scored on ``validation_data`` when the
  conf has them.
- ``validation_data`` and no ``async_sgd``: the model in ``model_input``
  is scored on the validation data (``ModelEvaluation``).

The system layer is not ported: the postoffice, heartbeats, dashboard
and recovery (ROADMAP A9, A12). Flags that need it raise
``NotImplementedError``, and so do confs for the darlin app (A10).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ...data.stream_reader import StreamReader
from ...learner.sgd import MinibatchReader
from ...learner.workload_pool import Workload, WorkloadPool
from .async_sgd import AsyncSGDWorker
from .config import parse_conf
from .model_evaluation import ModelEvaluation


def _unported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs the system layer, which is not ported to the "
        f"PyTorch package yet (ROADMAP {item})"
    )


def _data_format(dc) -> str:
    return dc.text if dc.format == "text" else dc.format


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("conf", help="path to a protobuf-text .conf file")
    ap.add_argument("--num-servers", type=int, default=1)
    ap.add_argument("--num-workers", type=int, default=0, help="0 = one (the only one)")
    ap.add_argument("--verbose", action="store_true", help="print progress per workload")
    ap.add_argument("--report-interval", type=float, default=0.0)
    ap.add_argument("--heartbeat-timeout", type=float, default=10.0)
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.num_servers != 1 or args.num_workers not in (0, 1):
        raise _unported("--num-servers/--num-workers other than 1", "A9")
    if args.report_interval:
        raise _unported("--report-interval", "A12")
    if args.heartbeat_timeout != 10.0:
        raise _unported("--heartbeat-timeout", "A12")
    if args.profile:
        raise _unported("--profile", "A12")
    with open(args.conf) as f:
        conf = parse_conf(f.read())
    return _run_app(conf, device if device is not None else args.device, args.verbose)


def _print_progress(worker: AsyncSGDWorker, elapsed: float) -> None:
    """One merged progress line (the JAX scheduler's table, at the end)."""
    p = worker.progress
    per_ex = sum(p.objective) / max(1, p.num_examples_processed)
    print(" sec  examples    loss      auc   accuracy")
    print(f"{elapsed:4.0f}  {p.num_examples_processed:.2e}  {per_ex:.5f}  "
          f"{np.mean(p.auc or [0]):.4f}  {np.mean(p.accuracy or [0]):.4f}", flush=True)


def _run_app(conf, device, verbose: bool = False) -> int:
    if conf.async_sgd is None:
        if conf.validation_data is not None:
            ModelEvaluation(conf, device=device).run()
            return 0
        print("config selects no app", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sgd = conf.async_sgd
    td = conf.training_data
    pool = WorkloadPool(Workload(files=list(td.file), replica=sgd.num_data_pass, shuffle=True))
    worker = AsyncSGDWorker(conf, device=device)
    while (load := pool.assign()) is not None:
        reader = MinibatchReader(
            files=load.files, minibatch_size=sgd.minibatch, data_format=_data_format(td)
        )
        if sgd.tail_feature_freq > 0:
            reader.init_filter(sgd.countmin_n, sgd.countmin_k, sgd.tail_feature_freq)
        with reader:
            worker.train(iter(reader))
        if verbose:
            print(f"workload {load.id} done: {load.files[0]}", flush=True)
    _print_progress(worker, time.perf_counter() - t0)
    if conf.model_output is not None and conf.model_output.file:
        files = worker.save_model(conf.model_output.file[0])
        print(f"model written to {', '.join(files)}")
    if conf.validation_data is not None and conf.validation_data.file:
        vd = conf.validation_data
        allb = StreamReader(vd.file, _data_format(vd)).read_all()
        if allb is not None:
            ev = worker.evaluate(allb)
            print(
                f"validation auc: {ev['auc']:.6f}, accuracy: {ev['accuracy']:.6f}, "
                f"logloss: {ev['logloss']:.6f}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
