"""The linear worker over a (data, server) mesh of ranks, measured.

Rank functions for ``parallel/launch.run_world``: every rank of a world
runs one, and the caller (``chip_smoke.py``'s mesh phase, the
``network`` benchmark) holds the results. On one card the ranks share
it and talk gloo, so each number here is of ranks sharing one card over
gloo, not of NCCL across cards.

- :func:`headline_meshes`: the headline worker (``benchmarks/headline.py``:
  2^22 slots, 16384-row minibatches of 39 binary keys from 2^24, T 8) on
  each mesh shape, sparse and dense, run twice: once timed, once with
  every collective of the step timed (each bracketed by synchronizations,
  so that run's wall time is not the first's); its shard of the state,
  digests, kernel launches and times.
- :func:`cli_rank`: the linear CLI inside the world, its output and its
  kernel launches, and on request its pushes and objectives.
- :func:`psum_ms`: the in-mesh ``psum`` of the JAX suite's ``network``
  benchmark, over the world's data axis.
- :func:`elastic_resizes`: the headline worker through live resizes
  (``system/elastic.py``), a server's death recovered from the neighbour
  replica, and the dense route with the push filter through one resize;
  the state before and after each resize, digests and times.
- :func:`rebalance_at_size`: a ``KVVector`` of the headline table over a
  1x4 mesh migrated by ``RebalanceController.execute(force=True)`` while a
  thread pushes headline batches.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import time
import types
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh as meshlib


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernels():
    from ..ops import ftrl, ftrl_sparse, quantize
    from ..ops import segment_sum as seg

    return {"ftrl_sparse": ftrl_sparse.ftrl_sparse_update, "ftrl_dense": ftrl.ftrl_update,
            "quantize": quantize.quantize, "segment_sum": seg.segment_sum}


def reset_launches() -> None:
    for fn in _kernels().values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: int(fn.launches) for name, fn in _kernels().items()}


def state_digest(state: Dict[str, np.ndarray]) -> str:
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_collectives(device: torch.device, sink: List[float]):
    """Every collective of the linear step (``psum``, ``all_gather``)
    bracketed by synchronizations and timed into ``sink``."""
    from ..apps.linear import async_sgd

    def timed(fn):
        def run(*args, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(device)
            sink.append(time.perf_counter() - t0)
            return out
        return run

    saved = (async_sgd.psum, meshlib.all_gather)
    async_sgd.psum, meshlib.all_gather = timed(saved[0]), timed(saved[1])
    try:
        yield
    finally:
        async_sgd.psum, meshlib.all_gather = saved


def _train(worker, batches, steps: int) -> None:
    for lo in range(0, len(batches), steps):
        group = batches[lo:lo + steps]
        if len(group) > 1:
            worker.submit_superbatch(group, with_aux=False)
        else:
            worker.wait(worker.process_minibatch(group[0], with_aux=False))


def headline_meshes(shapes: Sequence[Tuple[int, int]], seed: int, sparse_launches: int,
                    dense_steps: int, timed: bool = True) -> list:
    """On each mesh ``(num_data, num_server)`` of ``shapes`` (a prefix of
    the world; the other ranks idle), the headline worker, sparse
    (``sparse_launches`` launches of T) and dense (``dense_steps``
    minibatches), from the same seeded batches. Per shape and update:
    this rank's coordinates; the state's digest after each run; on data
    row 0 the state shard itself; the kernel launches of the first run;
    with ``timed``, both runs' wall time and the second's time inside
    collectives."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..benchmarks.headline import MB, T, conf, make_batch

    n = max(sparse_launches * T, dense_steps)
    batches = [make_batch(seed + i) for i in range(n)]
    out = []
    for d, s in shapes:
        mesh = meshlib.make_mesh(d, s)
        if not mesh.active:
            out.append(None)
            continue
        per = {}
        for update in ("sparse", "dense"):
            group = batches[:sparse_launches * T] if update == "sparse" else batches[:dense_steps]
            steps = T if update == "sparse" else 1
            rec = {"coords": mesh.coords, "device": str(mesh.device), "backend": mesh.backend}
            for run in (0, 1):
                worker = AsyncSGDWorker(conf(update), mesh=mesh, name=f"mesh_{update}_{run}")
                spent: List[float] = []
                reset_launches()
                ctx = (timed_collectives(mesh.device, spent) if timed and run == 1
                       else contextlib.nullcontext())
                try:
                    with ctx:
                        _sync(mesh.device)
                        t0 = time.perf_counter()
                        _train(worker, group, steps)
                        _sync(mesh.device)
                        wall = time.perf_counter() - t0
                    state = worker.state_host()["state"]
                finally:
                    worker.remove()
                rec[f"digest{run}"] = state_digest(state)
                if run == 0:
                    rec["launches"] = launches()
                    rec["update_path"] = worker.update_path
                    if mesh.data_index == 0:
                        rec["state"] = state
                if timed:
                    rec[f"wall_s{run}"] = wall
                    if run == 1:
                        rec["collective_s"] = float(sum(spent))
                        rec["collectives"] = len(spent)
            rec["ministeps"] = len(group)
            rec["examples"] = len(group) * MB
            per[update] = rec
        out.append(per)
    return out


@contextlib.contextmanager
def recorded_pushes():
    """Records, on the host, every quantization this rank's linear wire
    makes (its module's ``qops.quantize``; the kernel and its launch
    count are untouched): the positions of the input's nonzero entries,
    their codes, and the range. The wire keeps a code only where its
    entry is nonzero. Yields the list it fills."""
    from ..apps.linear import async_sgd

    seen, qops = [], async_sgd.qops

    def quantize_rec(x, seed, num_bytes=1):
        q, lo, hi = qops.quantize(x, seed, num_bytes)
        nz = torch.nonzero(x).reshape(-1)
        seen.append((nz.cpu().numpy(), q.index_select(0, nz).cpu().numpy(), float(lo), float(hi)))
        return q, lo, hi

    async_sgd.qops = types.SimpleNamespace(quantize=quantize_rec, dequantize=qops.dequantize)
    try:
        yield seen
    finally:
        async_sgd.qops = qops


def cli_rank(argv: List[str], record: bool = False) -> dict:
    """The linear CLI inside the world: its exit code, what it printed
    (rank 0 prints) and the kernel launches of this rank. With
    ``record``, also this rank's coordinates, its pushes
    (:func:`recorded_pushes`) and its worker's objective a submission."""
    from ..apps.linear import main as linear_main

    workers = []

    class Kept(linear_main.AsyncSGDWorker):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            workers.append(self)

    reset_launches()
    buf = io.StringIO()
    saved = linear_main.AsyncSGDWorker
    linear_main.AsyncSGDWorker = Kept
    try:
        with contextlib.redirect_stdout(buf), \
                (recorded_pushes() if record else contextlib.nullcontext([])) as pushes:
            rc = linear_main.main(argv)
    finally:
        linear_main.AsyncSGDWorker = saved
    out = {"rc": rc, "out": buf.getvalue(), "launches": launches()}
    if record:
        (worker,) = workers
        coords = (0, 0) if worker.mesh is None else tuple(worker.mesh.coords)
        out.update(coords=coords, pushes=pushes,
                   objective=list(worker.progress.objective))
    return out


def psum_ms(nfloats: int, reps: int) -> dict:
    """Milliseconds of one ``psum`` of ``nfloats`` float32 over the data
    axis of the whole world (the JAX suite's ``network_psum_ms``, whose
    mesh puts every device on the data axis): the mean of ``reps`` after
    one warm-up, each call waited for."""
    mesh = meshlib.make_mesh(None, 1)
    x = torch.ones(nfloats, dtype=torch.float32, device=mesh.device)
    out = meshlib.psum(x, meshlib.DATA_AXIS, mesh)
    _sync(mesh.device)
    assert float(out[0]) == mesh.shape[meshlib.DATA_AXIS]
    t0 = time.perf_counter()
    for _ in range(reps):
        meshlib.psum(x, meshlib.DATA_AXIS, mesh)
        _sync(mesh.device)
    return {"ms": (time.perf_counter() - t0) / reps * 1e3, "ranks": mesh.size,
            "backend": mesh.backend, "device": str(mesh.device), "bytes": nfloats * 4}


def _whole_digest(snap) -> str:
    return state_digest({**snap["state"], "seed_counter": np.asarray(snap["seed_counter"])})


def elastic_resizes(seed: int, dense_steps: int, tail: int) -> dict:
    """On every rank of a world of 4 (``system/elastic.py`` is a collective
    of the world): the headline worker (``num_replicas 1``, sparse, T 8)
    trained a launch of T at 2x1, ``add_server`` → 2x2, a launch,
    ``remove_worker`` → 1x2, a launch; server shard 1 wiped and
    ``handle_server_death(1)`` recovering it from the neighbour's replica;
    ``tail`` more ministeps; then a fresh worker on the final mesh given the
    snapshot taken before the tail and trained the same ``tail``. Then the
    dense route with the 1-byte push filter (``dense_steps`` ministeps at
    2x1, ``add_server``, ``dense_steps`` at 2x2). Each resize's whole
    state (gathered over the world) before and after, as digests; each
    pause; this rank's shard and replica digests around the recovery; the
    kernel launches of this rank; on rank 0 the final whole states and the
    dense state after its first ministep (a zero table's push)."""
    import torch.distributed as dist

    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..system.elastic import ElasticCoordinator, install_whole, whole_state
    from ..system.postoffice import Postoffice
    from .headline import T, conf, make_batch

    batches = [make_batch(seed + 9000 + i) for i in range(3 * T + tail)]
    rank = dist.get_rank()

    def make_sparse(mesh):
        c = conf("sparse")
        c.async_sgd.num_replicas = 1
        return AsyncSGDWorker(c, mesh=mesh, name="elastic_sparse")

    def make_dense(mesh):
        c = conf("dense", steps=1)
        c.async_sgd.push_filter = [{"type": "fixing_float", "num_bytes": 1}]
        return AsyncSGDWorker(c, mesh=mesh, name="elastic_dense")

    def train(co, group, launch: bool) -> None:
        if co.worker is None:
            return
        if launch:
            co.worker.submit_superbatch(group, with_aux=False)
        else:
            for b in group:
                co.worker.wait(co.worker.process_minibatch(b, with_aux=False))

    def resize(co, fn, what: str) -> None:
        before = whole_state(co.worker, Postoffice.instance().mesh)
        fn()
        after = whole_state(co.worker, Postoffice.instance().mesh)
        rec["resizes"].append(dict(what=what, old=co.resize_history[-1]["old"],
                                   new=co.resize_history[-1]["new"],
                                   pause_s=co.resize_history[-1]["pause_s"],
                                   before=_whole_digest(before), after=_whole_digest(after)))

    Postoffice.reset()
    reset_launches()
    rec = {"resizes": [], "rank": rank}
    co = ElasticCoordinator(make_sparse, num_data=2, num_server=1)
    co.start()
    train(co, batches[:T], True)
    resize(co, co.add_server, "add_server")
    train(co, batches[T:2 * T], True)
    resize(co, co.remove_worker, "remove_worker")
    train(co, batches[2 * T:3 * T], True)
    mesh = Postoffice.instance().mesh
    rec["coords_1x2"] = mesh.coords
    if co.worker is not None:
        rec["state_before_wipe"] = state_digest(co.worker.state_host()["state"])
        rec["replica"] = state_digest(co.worker.replica_host())
        co.worker.wipe_server_shard(1)
    rec["death"] = co.handle_server_death(1)
    if co.worker is not None:
        rec["state_after_recovery"] = state_digest(co.worker.state_host()["state"])
    snap = whole_state(co.worker, mesh)
    train(co, batches[3 * T:], False)
    final = whole_state(co.worker, mesh)
    rec["final"] = _whole_digest(final)
    if co.worker is not None:
        co.worker.remove()
    # the same tail on a world that starts on the final mesh from the snapshot
    Postoffice.reset()
    po = Postoffice.instance().start(num_data=1, num_server=2)
    w = make_sparse(po.mesh) if po.mesh.active else None
    if w is not None:
        install_whole(w, po.mesh, snap)
        for b in batches[3 * T:]:
            w.wait(w.process_minibatch(b, with_aux=False))
    restarted = whole_state(w, po.mesh)
    rec["restarted"] = _whole_digest(restarted)
    if w is not None:
        w.remove()
    Postoffice.reset()

    dense = ElasticCoordinator(make_dense, num_data=2, num_server=1)
    dense.start()
    train(dense, batches[:1], False)
    dense_first = whole_state(dense.worker, Postoffice.instance().mesh)
    train(dense, batches[1:dense_steps], False)
    resize(dense, dense.add_server, "dense add_server")
    train(dense, batches[dense_steps:2 * dense_steps], False)
    dense_final = whole_state(dense.worker, Postoffice.instance().mesh)
    if dense.worker is not None:
        dense.worker.remove()
    Postoffice.reset()
    rec["launches"] = launches()
    rec["pauses_s"] = [r["pause_s"] for r in rec["resizes"]]
    if rank == 0:
        rec["final_state"] = final["state"]
        rec["dense_first"] = dense_first["state"]
        rec["dense_state"] = dense_final["state"]
    return rec


def rebalance_at_size(seed: int, pushes: int, start_at: int, stall_s: float) -> dict:
    """On every rank of a 1x4 world: a ``KVVector`` of 2^22 slots, k 1, over
    the 4 server shards, fed ``pushes`` headline batches (their 638,976
    keys, seeded normal values) by a thread; after ``start_at`` pushes,
    ``RebalanceController.execute(force=True)`` plans from the key heat of
    those batches and migrates, stalled ``stall_s`` at
    ``rebalance.migrate`` so pushes land past its barrier. An undisturbed
    store of the same mesh takes the same pushes. Returns the record, both
    base-layout tables' digests (rank 0: the tables), and this rank's
    ``segment_sum`` launches in the live store's run."""
    import threading

    from ..parallel import partition as partlib
    from ..parameter.kv_vector import KVVector
    from ..system import faults
    from ..system.postoffice import Postoffice
    from ..telemetry.learning import KeyHeat
    from .headline import SLOTS, make_batch

    rng = np.random.default_rng(seed + 9400)
    stream = []
    for i in range(pushes):
        b = make_batch(seed + 9100 + i)
        stream.append((b.indices, rng.normal(size=(b.nnz, 1)).astype(np.float32)))
    Postoffice.reset()
    faults.reset()
    mesh = meshlib.make_mesh(1, 4)
    ref = KVVector(k=1, num_slots=SLOTS, hashed=True, name="reb_ref", mesh=mesh)
    for keys, vals in stream:
        ref.push(ref.request(channel=0), keys=keys, values=vals)
    ref.executor.wait_all(pop=False)
    want = ref.get_replica()[0]
    ref.executor.stop()

    kv = KVVector(k=1, num_slots=SLOTS, hashed=True, name="reb_live", mesh=mesh)
    heat = KeyHeat(num_slots=SLOTS, num_shards=4, top_k=16, decay_every=1 << 30)
    for keys, _ in stream[:start_at]:
        heat.note(kv.channel(0).directory.slots(keys))
    ctl = partlib.RebalanceController(kv, heat)
    acked = [0]
    reached = threading.Event()
    errors = []

    def pusher():
        try:
            for i, (keys, vals) in enumerate(stream):
                if i == start_at:
                    reached.set()
                    # the rest lands once the migration's journal is open
                    # (its plan is agreed first; the card pushes a batch in
                    # milliseconds)
                    deadline = time.monotonic() + 600
                    while kv.channel(0).journal is None and time.monotonic() < deadline:
                        time.sleep(0.001)
                kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
                acked[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            errors.append(repr(e))

    reset_launches()
    faults.arm("rebalance.migrate", kind="delay", delay_s=stall_s, once=True)
    t = threading.Thread(target=pusher, name="rebalance-pusher")
    t.start()
    reached.wait(600)
    t0 = time.perf_counter()
    record = ctl.execute(force=True)
    wall = time.perf_counter() - t0
    t.join(timeout=600)
    faults.reset()
    seg = launches()["segment_sum"]
    got = kv.get_replica()[0]
    kv.executor.stop()
    Postoffice.reset()
    out = {"record": record, "wall_s": wall, "acked": acked[0], "errors": errors,
           "segment_launches": seg, "coords": mesh.coords, "layout_moved": record is not None,
           "bit_equal": got.tobytes() == want.tobytes(), "digest": state_digest({"t": got})}
    if mesh.rank == 0:
        out["table"] = got
    return out
