"""Linear-method CLI: train the model a reference-style ``.conf`` selects.

    python -m parameter_server_tpu_torch.apps.linear.main <config.conf> [--device cpu]

Counterpart of ``parameter_server_tpu/apps/linear/main.py`` for the
``darlin`` and ``async_sgd`` apps and model evaluation, on one device
(the CUDA device unless ``--device`` names another).

- ``darlin``: the training files are read and localized in one batch,
  divided into feature blocks and trained by block coordinate descent
  (``DarlinScheduler``), printing a progress line a pass; the model goes
  to ``{model_output}_S0`` and the last progress line is printed again.
- ``async_sgd``: driven as the JAX CLI drives it, through an
  ``AsyncSGDScheduler`` (each ``training_data`` file pattern one workload
  a pass, for ``num_data_pass`` passes) whose monitor the worker reports
  each collected step to; ``sched.run()`` sets the progress printer (a
  line a second at most, and one forced at the end). A workload is read,
  parsed and passed through a fresh count-min tail filter on the
  reader's feeder thread, and trained on (``AsyncSGDWorker.train``).
  Then the model is written to ``model_output`` and scored on
  ``validation_data`` when the conf has them.
- ``validation_data`` and no ``async_sgd``: the model in ``model_input``
  is scored on the validation data (``ModelEvaluation``).

Every app runs as the JAX CLI's does, on a started postoffice with its
aux runtime (heartbeats, dashboard, recovery): the worker (or the darlin
scheduler, once its data is loaded) is registered as a node, a dead worker's file workloads go
back to the pool, ``--report-interval N`` prints the node dashboard
every N seconds (and at the end; ``--verbose`` prints it at the end),
``--heartbeat-timeout`` sets when a silent node is declared dead, and
``--profile DIR`` captures a ``torch.profiler`` trace of the run
(``utils/profiling.device_trace``). More than one server or worker
raises ``NotImplementedError`` naming ROADMAP A9.
"""

from __future__ import annotations

import argparse
import sys

from ...data.stream_reader import StreamReader
from ...learner.sgd import MinibatchReader
from ...system.postoffice import Postoffice
from ...utils.profiling import device_trace
from .async_sgd import AsyncSGDScheduler, AsyncSGDWorker
from .config import parse_conf
from .darlin import DarlinScheduler
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
    ap.add_argument("--verbose", action="store_true",
                    help="print progress per workload and the dashboard at the end")
    ap.add_argument("--report-interval", type=float, default=0.0,
                    help="print the node dashboard every N seconds (0 = at the end only)")
    ap.add_argument("--heartbeat-timeout", type=float, default=10.0,
                    help="seconds without a heartbeat before a node is declared dead")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the run into DIR (Chrome trace)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.num_servers != 1 or args.num_workers not in (0, 1):
        raise _unported("--num-servers/--num-workers other than 1", "A9")
    with open(args.conf) as f:
        conf = parse_conf(f.read())
    po = Postoffice.instance().start(device=device if device is not None else args.device)
    # heartbeat -> dashboard -> recovery, running for every app
    aux = po.start_aux(heartbeat_timeout=args.heartbeat_timeout)
    aux.start(check_interval=max(0.2, args.heartbeat_timeout / 5),
              dashboard_interval=args.report_interval)
    try:
        with device_trace(args.profile):
            rc = _run_app(conf, po.device, aux, args.verbose)
        if rc:
            return rc
        if args.verbose or args.report_interval > 0:
            print(aux.dashboard.report(), flush=True)
    finally:
        po.stop()
    return 0


def _run_darlin(conf, device, aux) -> int:
    sched = DarlinScheduler(conf, device=device)
    td = conf.training_data
    sched.load_data(td.file, _data_format(td))
    # registered once its data is in: the scheduler beats from its block
    # loop, and a load longer than the heartbeat timeout is no death
    aux.register(sched.name)
    sched.run_loaded(verbose=True)
    if conf.model_output is not None and conf.model_output.file:
        files = sched.save_model(conf.model_output.file[0])
        print(f"model written to {', '.join(files)}")
    print(sched.show_progress(max(sched.g_progress) if sched.g_progress else 0), flush=True)
    return 0


def _run_app(conf, device, aux, verbose: bool = False) -> int:
    if conf.darlin is not None:
        return _run_darlin(conf, device, aux)
    if conf.async_sgd is None:
        if conf.validation_data is not None:
            ModelEvaluation(conf, device=device).run()
            return 0
        print("config selects no app", file=sys.stderr)
        return 2
    sched = AsyncSGDScheduler(conf)
    sched.run()
    worker = AsyncSGDWorker(conf, device=device)
    worker.attach_monitor(sched)
    aux.register(worker.name)
    # a dead worker's file workloads go back to the pool
    aux.coordinator.on_worker_dead(sched.workload_pool.restore)
    sgd = conf.async_sgd
    td = conf.training_data
    while (load := sched.workload_pool.assign(worker.name)) is not None:
        reader = MinibatchReader(
            files=load.files, minibatch_size=sgd.minibatch, data_format=_data_format(td)
        )
        if sgd.tail_feature_freq > 0:
            reader.init_filter(sgd.countmin_n, sgd.countmin_k, sgd.tail_feature_freq)
        with reader:
            worker.train(iter(reader))
        sched.workload_pool.finish(load.id)
        if verbose:
            print(f"workload {load.id} done: {load.files[0]}", flush=True)
    sched.monitor.maybe_print(force=True)
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
