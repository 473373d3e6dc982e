"""Linear-method CLI: train the model a reference-style ``.conf`` selects.

    python -m parameter_server_tpu_torch.apps.linear.main <config.conf> [--device cpu]
        [--num-servers S] [--num-workers D]

Counterpart of ``parameter_server_tpu/apps/linear/main.py`` for the
``darlin`` and ``async_sgd`` apps and model evaluation, on one device
(the CUDA device unless ``--device`` names another), or for
``async_sgd`` on a ``(data, server)`` mesh of ``D x S`` ranks:

- inside a world a launcher started (``PS_COORDINATOR_ADDRESS``,
  ``PS_NUM_PROCESSES``, ``PS_PROCESS_ID`` set on every rank), each rank
  joins it and builds its mesh with the JAX CLI's rules (``--num-workers``
  0 spreads the data axis over the world);
- otherwise, with ``D x S > 1`` (``--num-workers`` 0 meaning one), the
  CLI starts the ``D x S`` ranks itself (``parallel/launch.py``, start
  method ``spawn``), rank ``r`` on ``cuda:(r mod device_count)``, or on
  the CPU with ``--device cpu``; ranks share a card over gloo, and NCCL
  runs when each has one of its own. The chosen backend is printed.
  With no card and no ``--device`` (or, in a launcher's world, no
  ``PS_DEVICE``) it raises, as the one-process CLI does.

Every rank runs the same program on the same stream (rank 0 draws the
workload shuffle's seed and the others take it from the rendezvous
store); rank 0 prints what the single-process CLI prints, and the ranks
of data row 0 write the model, ``{model_output}_S{s}`` from the rank
holding server shard ``s``. Every app runs on a mesh: ``async_sgd`` and
``darlin`` over its data and server axes, model evaluation once, on rank
0 (the JAX CLI runs it once whatever the mesh), the other ranks leaving
at once.

- ``darlin``: the training files are read and localized in one batch,
  divided into feature blocks and trained by block coordinate descent
  (``DarlinScheduler``, on a mesh the examples split over its data
  axis), printing a progress line a pass; the model goes to
  ``{model_output}_S{s}``, one file a server shard, and the last
  progress line is printed again.
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
(``utils/profiling.device_trace``).
"""

from __future__ import annotations

import argparse
import os
import random
import sys

from ...data.stream_reader import StreamReader
from ...learner.sgd import MinibatchReader
from ...system.postoffice import Postoffice
from ...utils.profiling import device_trace
from .async_sgd import AsyncSGDScheduler, AsyncSGDWorker
from .config import parse_conf
from .darlin import DarlinScheduler
from .model_evaluation import ModelEvaluation


def _data_format(dc) -> str:
    return dc.text if dc.format == "text" else dc.format


def _rank_main(argv, device) -> int:
    """One rank of a world the CLI started: the CLI again, inside it."""
    return main(argv, device=device)


def _agree_on_random() -> None:
    """Seed Python's ``random`` (the workload pool's shuffle) alike on
    every rank of the world: rank 0 draws the seed, the others read it
    from the rendezvous store."""
    import torch.distributed as dist

    from ...parallel import distributed

    if not distributed.is_multiprocess():
        return
    if dist.get_rank() == 0:
        seed = os.urandom(8)
        distributed.post_bytes("linear_cli/random_seed", seed)
    else:
        seed = distributed.fetch_bytes("linear_cli/random_seed")
    random.seed(int.from_bytes(seed, "little"))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("conf", help="path to a protobuf-text .conf file")
    ap.add_argument("--num-servers", type=int, default=1)
    ap.add_argument("--num-workers", type=int, default=0,
                    help="data rows of the mesh (0: over the launcher's world, else one)")
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
    with open(args.conf) as f:
        conf = parse_conf(f.read())
    device = device if device is not None else args.device
    world = max(1, args.num_workers) * args.num_servers
    if not os.environ.get("PS_COORDINATOR_ADDRESS") and world > 1:
        return _spawn(argv if argv is not None else sys.argv[1:], world, device)
    po = Postoffice.instance().start(num_data=args.num_workers or None,
                                     num_server=args.num_servers, device=device)
    if po.mesh.size > 1:
        if po.mesh.rank == 0:
            print(f"mesh {po.mesh.shape['data']}x{po.mesh.shape['server']} (data x server) "
                  f"over {po.mesh.backend}, rank 0 on {po.device}", flush=True)
        _agree_on_random()
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


def _spawn(argv, world: int, device) -> int:
    """Start the world's ranks, each running this CLI inside it; the
    worst rank's exit code."""
    import torch

    from ...device import resolve
    from ...parallel import distributed, launch

    device_type = resolve(device).type  # the card unless --device names another
    if device_type == "cuda":
        # every rank loads the kernels the launching process built
        from ...kernels import build_all

        build_all()
    backend = distributed.choose_backend(world, torch.device(device_type))
    print(f"starting {world} ranks on {device_type} over {backend}", flush=True)
    # no time limit on a training run; a rank that fails fails the world
    from . import main as cli  # by its import name: a rank cannot import a `-m` run's __main__

    codes = launch.run_world(cli._rank_main, world, args=(argv, None), timeout=None,
                             device_type=device_type, threads=0, quiet=True)
    return max(int(c or 0) for c in codes)


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
            mesh = Postoffice.instance().mesh
            if mesh is None or mesh.rank == 0:
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
