"""The linear app's and the ps.h layer's last mesh features, measured.

Rank functions for ``parallel/launch.run_world`` (``chip_smoke.py``'s
phase 9e): every rank of a world runs one, at the headline's full width
(``benchmarks/headline.py``: 2^22 slots, 16384-row minibatches of 39
binary keys from 2^24), and the caller holds the results. On one card
the ranks share it and talk gloo, so each number here is of ranks
sharing one card over gloo, not of NCCL across cards.

- :func:`slice_meshes`: (a) the KKT filter (one launch of T at 1x2 and
  2x2; the host drop set over per-minibatch launches at 2x2), (b) the
  encoded exact wire against the raw wire at 2x2, pipelined, two passes
  over the same batches, (c) the linear CLI under adaptive τ
  (:func:`cli_rank_tau`), (e) a ps.h program through ``ps.run_system``
  at 2 workers x 2 servers, (f) ``checkpoint_async`` at 2x2; each part's
  kernel launches and, on the card, each kernel held to its plain
  version on the first launch's inputs of the part.
- :func:`cli_rank_tau`: the linear CLI with adaptive τ set after the
  parse (the reference's parser reads no ``tau_adaptive``): the τ
  trajectory, the launches, the examples and the wall.
- :func:`darlin_cli_rank`: the linear CLI on a darlin conf, with its
  block steps counted.
"""

from __future__ import annotations

import contextlib
import io
import os
import time
import zipfile
from typing import Dict, List

import numpy as np
import torch

from ..parallel import mesh as meshlib
from .mesh import _kernels, _sync, launches, reset_launches, state_digest


# -- each kernel held to its plain version on its first inputs of a part --


@contextlib.contextmanager
def first_inputs():
    """Records the first call of each kernel's wrapper in this process
    (owned copies of its tensors, and its keywords), where the linear
    step, the darlin step and the stores call them. Yields the dict it
    fills: name -> (args, kwargs)."""
    from ..apps.linear import async_sgd, darlin, updaters
    from ..ops import kv_ops

    seen: Dict[str, tuple] = {}

    def keep(name, fn):
        def run(*args, **kw):
            if name not in seen:
                seen[name] = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args), dict(kw))
            return fn(*args, **kw)
        return run

    patches = [(updaters, "ftrl_sparse_update"), (updaters, "ftrl_update"),
               (async_sgd, "_segment_sum"), (darlin, "segment_sum"), (kv_ops, "segment_sum")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patches if hasattr(mod, name)]
    names = {"ftrl_sparse_update": "ftrl_sparse", "ftrl_update": "ftrl_dense",
             "_segment_sum": "segment_sum", "segment_sum": "segment_sum"}
    for mod, name, fn in saved:
        setattr(mod, name, keep(names[name], fn))
    qsaved = async_sgd.qops

    class _Q:
        dequantize = staticmethod(qsaved.dequantize)
        quantize = staticmethod(keep("quantize", qsaved.quantize))

    async_sgd.qops = _Q
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        async_sgd.qops = qsaved


def hold_to_plain(seen: Dict[str, tuple]) -> Dict[str, float]:
    """Each recorded first call run again through the kernel and through
    its plain version on copies of the same inputs: raises unless their
    bits are equal; returns each kernel's max |diff| (0.0). Launches made
    here are taken back out of the kernels' counts."""
    from ..filter import fixing_float
    from ..ops import ftrl, ftrl_sparse, quantize
    from ..ops import segment_sum as seg

    before = launches()
    errs = {}
    for name, (args, kw) in seen.items():
        if not isinstance(args[0], torch.Tensor) or args[0].device.type != "cuda":
            continue
        if name == "ftrl_sparse":
            z, n, rel, ok, g = args[:5]
            zk, nk, zr, nr = z.clone(), n.clone(), z.clone(), n.clone()
            ftrl_sparse.ftrl_sparse_update(zk, nk, rel, ok, g, **kw)
            ftrl_sparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g, **kw)
            pairs = ((zk, zr), (nk, nr))
        elif name == "ftrl_dense":
            z, n, g = args[:3]
            touched = args[3] if len(args) > 3 else kw.pop("touched", None)
            zk, nk, zr, nr = z.clone(), n.clone(), z.clone(), n.clone()
            ftrl.ftrl_update(zk, nk, g, touched, **kw)
            ftrl.ftrl_update_ref(zr, nr, g, touched, **kw)
            pairs = ((zk, zr), (nk, nr))
        elif name == "quantize":
            x, s = args[:2]
            nb = args[2] if len(args) > 2 else kw.get("num_bytes", 1)
            qk, lo, hi = quantize.quantize(x, s, nb)
            lo_p, hi_p = fixing_float.quantize_range(x)
            qp = fixing_float.quantize_codes(x, lo_p, hi_p, int(s) & 0xFFFFFFFF, nb)
            pairs = ((qk.to(torch.int32), qp.to(torch.int32)),
                     (torch.stack([lo, hi]), torch.stack([lo_p, hi_p])))
        else:  # segment_sum
            data, ids, num = args[:3]
            presorted = kw.get("presorted", args[3] if len(args) > 3 else False)
            out = seg.segment_sum(data, ids, num, presorted=presorted)
            # the plain version in entry order: index_add_ on the CPU (on the
            # card its atomics add in no fixed order)
            plain = seg.segment_sum(data.cpu(), ids.cpu(), num).to(data.device)
            pairs = ((out, plain),)
        torch.cuda.synchronize()
        err = 0.0
        for a, b in pairs:
            err = max(err, float((a.float() - b.float()).abs().max()) if a.numel() else 0.0)
            same = torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
            if not same:
                raise RuntimeError(f"{name}: the kernel differs from its plain version on a "
                                   f"mesh launch's inputs (max |diff| {err})")
        errs[name] = err
    # the comparisons' launches are not the path's
    for k, fn in _kernels().items():
        fn.launches = before[k]
    return errs


@contextlib.contextmanager
def _part(rec: dict, name: str, device: torch.device, hold: bool):
    """One part of :func:`slice_meshes`: its launches (counts reset at
    its start), its wall, and its kernels held to their plain versions."""
    reset_launches()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ctx = first_inputs() if hold else contextlib.nullcontext({})
    with ctx as seen:
        out: dict = {}
        yield out
    _sync(device)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = launches()
    if hold:
        out["held"] = hold_to_plain(seen)
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    rec[name] = out


def _kkt_conf(**sgd):
    from .headline import conf

    c = conf("sparse")
    for k, v in sgd.items():
        setattr(c.async_sgd, k, v)
    return c


def _whole_host(worker, mesh) -> dict:
    """The whole state (a gather over the server axis: every rank)."""
    from ..convert import state_to_numpy

    worker._drain()
    return state_to_numpy({k: meshlib.all_gather(v, meshlib.SERVER_AXIS, mesh)
                           if v.dim() >= 1 else v for k, v in worker.state.items()})


def kkt_parts(rec, mesh_shapes, batches, drop_batch, drop_steps, escape, hold):
    """(a) one launch of the KKT filter's headline worker on each mesh of
    ``mesh_shapes`` (rank 0 keeps the whole state); the host drop set at
    2x2 over ``drop_steps`` per-minibatch launches of ``drop_batch``
    (pipelined; none with 0)."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..system.postoffice import Postoffice

    for d, s in mesh_shapes:
        mesh = meshlib.make_mesh(d, s)
        if not mesh.active:
            continue
        Postoffice.reset()
        with _part(rec, f"kkt_{d}x{s}", mesh.device, hold) as out:
            w = AsyncSGDWorker(_kkt_conf(kkt_filter=True, kkt_escape=escape), mesh=mesh)
            try:
                # a train collects, so the tracker counts the launch
                w.train(iter(batches), pipelined=False)
                whole = _whole_host(w, mesh)
                out.update(coords=mesh.coords, digest=state_digest(whole),
                           summary=w._consistency.tracker.summary(),
                           objective=[float(x) for x in w.progress.objective])
                out["examples"] = int(w.progress.num_examples_processed)
                if mesh.rank == 0:
                    out["state"] = whole
            finally:
                w.remove()
    if not drop_steps:
        Postoffice.reset()
        return
    mesh = meshlib.make_mesh(2, 2)
    Postoffice.reset()
    with _part(rec, "drop_2x2", mesh.device, False) as out:
        w = AsyncSGDWorker(_kkt_conf(kkt_filter=True, kkt_margin=1e9, kkt_escape=0.0,
                                     kkt_drop_after=2, kkt_revisit_every=5, ingest_workers=1,
                                     steps_per_launch=1), mesh=mesh)
        try:
            w.train(iter([drop_batch] * drop_steps), pipelined=True)
            tr = w._consistency.tracker
            out.update(coords=mesh.coords, summary=tr.summary(), stamp=tr.stamp(),
                       digest=state_digest(_whole_host(w, mesh)))
        finally:
            w.remove()
    Postoffice.reset()


def encoded_part(rec, batches, hold):
    """(b) at 2x2, pipelined, T 8: the raw exact wire and the encoded
    one with the upload cache, each over two passes of ``batches`` in one
    ``train``: state digests, bytes copied to the card a example, and the
    cache's hits and misses."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..system.postoffice import Postoffice
    from .headline import conf

    mesh = meshlib.make_mesh(2, 2)
    for name, enc in (("raw", ""), ("encoded", "exact")):
        Postoffice.reset()
        with _part(rec, f"wire_{name}", mesh.device, hold and bool(enc)) as out:
            c = conf("sparse")
            c.async_sgd.wire_encode = enc
            c.async_sgd.wire_cache_mb = 256 if enc else 0
            w = AsyncSGDWorker(c, mesh=mesh)
            try:
                w.train(iter(list(batches) * 2), pipelined=True)
                examples = int(w.progress.num_examples_processed)
                copied = w.staging.copied_bytes if w.staging is not None else None
                cache = w.upload_cache
                out.update(coords=mesh.coords, examples=examples,
                           digest=state_digest(_whole_host(w, mesh)),
                           copied_bytes_per_example=None if copied is None else copied / examples,
                           hits=None if cache is None else (cache.hits, cache.misses))
            finally:
                w.remove()
    Postoffice.reset()


def ps_part(rec, stream, slots, hold):
    """(e) phase 8e's ps.h program at 2 workers x 2 servers: the server
    app's ``KVVector`` (``slots`` x 1, sharded over the server axis);
    worker ``W<i>`` pushes its share of ``stream`` (items ``i, i + 2,
    ...``), pulls the first 1024 keys back and submits a control task to
    the server group after each push."""
    from .. import ps
    from ..learner.wire import wire_filter_specs
    from ..parameter.kv_vector import KVVector
    from ..system.message import Task

    shared: dict = {}
    rtt: List[float] = []

    class Server(ps.App):
        def __init__(self):
            super().__init__()
            if ps.my_node_id() == "S0":
                shared["kv"] = KVVector(k=1, num_slots=slots, hashed=True, name="ps_mesh_kv")

        def run(self):
            if ps.my_node_id() == "S0":
                shared["table"] = shared["kv"].get_replica()[0]

    class Worker(ps.App):
        def run(self):
            kv = shared["kv"]
            for keys, vals in stream[ps.my_rank()::2]:
                kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
                kv.wait_pull(kv.pull(kv.request(channel=0), keys=keys[:1024]))
                t0 = time.perf_counter()
                self.wait(ps.submit(self, Task(filters=wire_filter_specs(1)),
                                    ps.NodeGroups.SERVER_GROUP))
                rtt.append((time.perf_counter() - t0) * 1e3)

    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    with _part(rec, "ps", dev, hold) as out:
        try:
            apps = ps.run_system(lambda: Server() if ps.is_server() else
                                 (Worker() if ps.is_worker() else ps.App()),
                                 num_workers=2, num_servers=2)
        finally:
            if "kv" in shared:
                shared["kv"].executor.stop()
        van = apps[0].po.van
        out.update(nodes=[a.node.id for a in apps], digest=state_digest({"t": shared["table"]}),
                   van=(van.wire_sent_bytes, van.wire_recv_bytes),
                   remote=(sum(rn.wire_sent_bytes for a in apps for rn in a.remote_nodes.nodes()),
                           sum(rn.wire_recv_bytes for a in apps for rn in a.remote_nodes.nodes())),
                   rtt_ms_median=float(np.median(rtt)), pushes=len(stream))
        if torch.distributed.get_rank() == 0:
            out["table"] = shared["table"]


def checkpoint_part(rec, head, tail, tmp, hold):
    """(f) at 2x2: the headline worker trains ``head`` (one launch),
    ``checkpoint_async`` (its return time; rank 0 its write time) and
    ``checkpoint`` into another directory; trains ``tail``; a fresh
    worker restores the async checkpoint and trains ``tail``."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..parameter.replica import CheckpointManager
    from ..system.postoffice import Postoffice
    from .headline import conf

    mesh = meshlib.make_mesh(2, 2)
    Postoffice.reset()
    with _part(rec, "checkpoint", mesh.device, hold) as out:
        w = AsyncSGDWorker(conf("sparse"), mesh=mesh)
        m_async = CheckpointManager(os.path.join(tmp, "ckpt_async"))
        m_sync = CheckpointManager(os.path.join(tmp, "ckpt_sync"))
        try:
            w.submit_superbatch(head, with_aux=False)
            w._drain()
            t0 = time.perf_counter()
            p_async = w.checkpoint_async(m_async, 1)
            out["return_ms"] = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            m_async.wait()
            out["write_wait_ms"] = (time.perf_counter() - t1) * 1e3
            t0 = time.perf_counter()
            p_sync = w.checkpoint(m_sync, 1)
            out["sync_ms"] = (time.perf_counter() - t0) * 1e3
            w.submit_superbatch(tail, with_aux=False)
            unbroken = state_digest(w.state_host()["state"])
        finally:
            w.remove()
        fresh = AsyncSGDWorker(conf("sparse"), mesh=mesh)
        try:
            out["step"] = fresh.restore(m_async)
            fresh.submit_superbatch(tail, with_aux=False)
            resumed = state_digest(fresh.state_host()["state"])
        finally:
            fresh.remove()
        out.update(coords=mesh.coords, resumed_bit_equal=unbroken == resumed)
        if mesh.rank == 0:
            members = []
            for p in (p_async, p_sync):
                with zipfile.ZipFile(os.path.join(p, "arrays.npz")) as z:
                    members.append({n: z.read(n) for n in z.namelist()})
            out["members_equal"] = members[0] == members[1]
            out["bytes"] = sum(len(v) for v in members[0].values())
    Postoffice.reset()


def slice_meshes(seed: int, kkt_shapes, drop_steps: int, ps_pushes: int, tmp: str,
                 hold: bool = True,
                 parts=("kkt", "drop", "wire", "ps", "checkpoint", "tau"),
                 tau_argv=None) -> dict:
    """Phase 9e's parts (a), (b), (c), (e) and (f) on this rank of a world
    of 4 (each part's mesh a prefix of it): ``hold`` holds each part's
    kernels to their plain versions on its first launch's inputs (the
    card); ``parts`` the parts to run (the CPU world runs the KKT launches
    and the τ CLI); ``tau_argv`` the linear CLI's arguments of (c)."""
    from ..parallel import distributed
    from .headline import SLOTS, T, make_batch

    rec: Dict[str, object] = {"rank": torch.distributed.get_rank(),
                              "device": str(distributed.rank_device())}
    batches = [make_batch(seed + i) for i in range(T)]
    if "kkt" in parts:
        kkt_parts(rec, kkt_shapes, batches, batches[0], drop_steps if "drop" in parts else 0,
                  1.0 / 64.0, hold)
    if "wire" in parts:
        encoded_part(rec, batches, hold)
    if "ps" in parts:
        rng = np.random.default_rng(seed + 8500)
        stream = []
        for i in range(ps_pushes):
            b = batches[i] if i < len(batches) else make_batch(seed + 9100 + i)
            stream.append((b.indices, rng.normal(size=(b.nnz, 1)).astype(np.float32)))
        ps_part(rec, stream, SLOTS, hold)
    if "checkpoint" in parts:
        tail = [make_batch(seed + 100 + i) for i in range(T)]
        checkpoint_part(rec, batches, tail, tmp, hold)
    if "tau" in parts:
        dev = distributed.rank_device()
        with _part(rec, "tau", dev, hold) as out:
            out.update(cli_rank_tau(tau_argv))
    return rec


# -- the CLI inside a world --


def cli_rank_tau(argv: List[str]) -> dict:
    """The linear CLI with adaptive τ set after the parse: ``mesh.cli_rank``'s
    record (``detail``) and the worker's τ trajectory and episodes."""
    from ..apps.linear import main as linear_main
    from .mesh import cli_rank

    parse, workers = linear_main.parse_conf, []
    saved = linear_main.AsyncSGDWorker

    def adaptive(text):
        c = parse(text)
        c.async_sgd.tau_adaptive = True
        return c

    class Kept(saved):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            workers.append(self)

    linear_main.parse_conf, linear_main.AsyncSGDWorker = adaptive, Kept
    try:
        out = cli_rank(argv, detail=True)
    finally:
        linear_main.parse_conf, linear_main.AsyncSGDWorker = parse, saved
    ctl = workers[0]._consistency.controller
    out.update(tau_trace=list(ctl.tau_trace), episodes=list(ctl.episodes),
               ministeps=out["submissions"])
    return out


def darlin_cli_rank(argv: List[str]) -> dict:
    """The linear CLI on a darlin conf inside the world: its exit code,
    its output (every rank prints), its launches, its block steps and its
    wall; the load + localize, upload and passes seconds."""
    from ..apps.linear import darlin
    from ..apps.linear import main as linear_main

    steps = [0]
    times: Dict[str, float] = {}
    saved_dispatch = darlin.DarlinSolver.dispatch_block
    saved_load = darlin.DarlinScheduler.load_data
    saved_init = darlin.DarlinSolver.init_data

    def dispatch(self, *a, **k):
        steps[0] += 1
        return saved_dispatch(self, *a, **k)

    def timed(key, fn):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            if getattr(self, "device", torch.device("cpu")).type == "cuda":
                torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    darlin.DarlinSolver.dispatch_block = dispatch
    darlin.DarlinScheduler.load_data = timed("load_localize_s", saved_load)
    darlin.DarlinSolver.init_data = timed("upload_s", saved_init)
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = linear_main.main(argv)
    finally:
        darlin.DarlinSolver.dispatch_block = saved_dispatch
        darlin.DarlinScheduler.load_data = saved_load
        darlin.DarlinSolver.init_data = saved_init
    dev = torch.device("cuda") if torch.cuda.is_available() else None
    return {"rc": rc, "out": buf.getvalue(), "launches": launches(), "block_steps": steps[0],
            "wall_s": time.perf_counter() - t0, **times,
            "rank": torch.distributed.get_rank() if torch.distributed.is_initialized() else 0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if dev is not None else 0.0}


def eval_cli_rank(argv: List[str]) -> dict:
    """The linear CLI on an eval conf inside the world: exit code and
    output (rank 0 alone evaluates and prints)."""
    from ..apps.linear import main as linear_main

    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = linear_main.main(argv)
    return {"rc": rc, "out": buf.getvalue(), "launches": launches(),
            "rank": torch.distributed.get_rank()}

