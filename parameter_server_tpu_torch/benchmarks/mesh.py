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


def cli_rank(argv: List[str], record: bool = False, state: bool = False,
             detail: bool = False) -> dict:
    """The linear CLI inside the world: its exit code, what it printed
    (rank 0 prints), the kernel launches of this rank and the CLI's wall
    seconds on it. With ``record``, also this rank's coordinates, its
    pushes (:func:`recorded_pushes`) and its worker's objective a
    submission. With ``detail`` (or ``state``), also this rank's
    coordinates, its worker's update route, the wires it submitted, the
    examples it trained on, and its peak device memory (0 off the card);
    with ``state``, also its server shard of the state at the end."""
    from ..apps.linear import main as linear_main
    from ..convert import state_to_numpy

    workers, kinds = [], []

    class Kept(linear_main.AsyncSGDWorker):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            workers.append(self)

        def _submit_prepped(self, prepped, with_aux=True):
            kinds.append(type(prepped).__name__)
            return super()._submit_prepped(prepped, with_aux)

    reset_launches()
    buf = io.StringIO()
    saved = linear_main.AsyncSGDWorker
    linear_main.AsyncSGDWorker = Kept
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), \
                (recorded_pushes() if record else contextlib.nullcontext([])) as pushes:
            rc = linear_main.main(argv)
    finally:
        linear_main.AsyncSGDWorker = saved
    out = {"rc": rc, "out": buf.getvalue(), "launches": launches(),
           "wall_s": time.perf_counter() - t0}
    if state or detail:
        (worker,) = workers
        dev = worker.device
        out.update(coords=(0, 0) if worker.mesh is None else tuple(worker.mesh.coords),
                   update=worker._update_mode, kinds=sorted(set(kinds)),
                   submissions=len(kinds), examples=int(worker.progress.num_examples_processed),
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if state:
        out["state"] = state_to_numpy(workers[0].state)
    if record:
        (worker,) = workers
        coords = (0, 0) if worker.mesh is None else tuple(worker.mesh.coords)
        out.update(coords=coords, pushes=pushes,
                   objective=list(worker.progress.objective))
    return out


def cli_rank_dense(argv: List[str]) -> dict:
    """:func:`cli_rank` (``detail``) with the ``update="auto"`` flip raised
    past any table, so a one-card run of a 2^30 conf takes the dense
    update that a mesh's shards below the flip take."""
    from ..apps.linear import async_sgd

    saved = async_sgd.sparse_update_min_slots
    async_sgd.sparse_update_min_slots = lambda: 1 << 62
    try:
        return cli_rank(argv, detail=True)
    finally:
        async_sgd.sparse_update_min_slots = saved


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


# -- the ELL wires and the A10 stores over a mesh (chip_smoke.py phase 9d) --


def criteo_like_batch(seed: int, rows: int, lanes: int, small: int = 13,
                      vocab: int = 40):
    """A uniform binary batch of ``lanes`` keys a row and ±1 labels, its
    first ``small`` lanes from vocabularies of ``vocab`` keys (the lanes
    the stream wire's dictionary takes), the rest from 2^40; labels from
    the small lanes' keys, so that the weights move."""
    from ..utils.sparse import SparseBatch

    rng = np.random.default_rng(seed)
    few = rng.integers(0, vocab, (rows, small))
    wide = rng.integers(0, 1 << 40, (rows, lanes - small))
    keys = np.concatenate([few + (np.arange(small) << 50), wide], axis=1).astype(np.int64)
    y = np.where(few.sum(1) % 3 == 0, 1.0, -1.0).astype(np.float32)
    return SparseBatch(y=y, indptr=np.arange(0, rows * lanes + 1, lanes, dtype=np.int64),
                       indices=keys.ravel())


def _ell_batches(wire: str, seed: int, n: int) -> list:
    from .headline import MB, NNZ, make_batch

    if wire == "stream":
        return [criteo_like_batch(seed + 500 + i, MB, NNZ) for i in range(n)]
    return [make_batch(seed + i) for i in range(n)]


def _ell_conf(wire: str, steps: int, push: int, dtype: str = "float32"):
    from .headline import NNZ, conf

    c = conf("dense", dtype, steps)
    c.async_sgd.ell_lanes, c.async_sgd.wire = NNZ, wire
    if push:
        c.async_sgd.push_filter = [{"type": "fixing_float", "num_bytes": push}]
    return c


@contextlib.contextmanager
def _timed_psums(device: torch.device, sink: list):
    """Every ``psum`` of the linear step bracketed by synchronizations,
    recorded into ``sink`` as ``(axis, floats, seconds)``."""
    from ..apps.linear import async_sgd

    saved = async_sgd.psum

    def timed(x, axis, mesh):
        _sync(device)
        t0 = time.perf_counter()
        out = saved(x, axis, mesh)
        _sync(device)
        sink.append((axis, int(x.numel()), time.perf_counter() - t0))
        return out

    async_sgd.psum = timed
    try:
        yield
    finally:
        async_sgd.psum = saved


def _objectives(worker, batches, steps: int) -> List[float]:
    out = []
    for lo in range(0, len(batches), steps):
        group = batches[lo:lo + steps]
        if len(group) > 1:
            m = worker.submit_superbatch(group, with_aux=False)
        else:
            m = worker.wait(worker.process_minibatch(group[0], with_aux=False))
        out.append(float(m["objective"].sum()))
    return out


def _first_part(seed: int, n: int, mesh) -> dict:
    """Where the ``1 x 2`` bits wire with bf16 √n parts from the one-card
    run on the same batches: this rank's shard compared with its rows of
    the one-card state after every ministep; the first ministep and
    leaf that differ (None where none does)."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..convert import state_to_numpy

    batches = _ell_batches("bits", seed, n)
    runs = []
    for m in (mesh, None):
        w = AsyncSGDWorker(_ell_conf("bits", 1, 0, "bfloat16"), mesh=m, device=mesh.device)
        snaps = []
        for b in batches:
            w.wait(w.process_minibatch(b, with_aux=False))
            snaps.append(state_to_numpy(w.state))
        w.remove()
        runs.append(snaps)
    rows = runs[0][0]["z"].shape[0]
    lo = mesh.server_index * rows
    for step, (mine, one) in enumerate(zip(*runs), 1):
        for k in sorted(mine):
            a, b = mine[k], one[k][lo:lo + rows]
            if a.tobytes() != b.tobytes():
                differ = int((a.view(np.uint16 if a.itemsize == 2 else np.uint32)
                              != b.view(np.uint16 if b.itemsize == 2 else np.uint32)).sum())
                return {"ministep": step, "leaf": k, "elements": differ}
    return {"ministep": None, "leaf": None, "elements": 0}


def _a10_one_by_two(seed: int, mesh, steps: int) -> dict:
    """FM and wide&deep (the headline ELL conf, k 8, hidden (64, 32)) and
    ``KVMap`` (2^22 slots, k 8, AddEntry and AssignEntry) on this rank of
    a ``1 x 2`` mesh, each against the same run on one card on this
    rank's device: this rank's rows bit-equal, the objectives, the
    segment_sum launches of the mesh run."""
    from ..apps.linear.deep_ctr import DeepCTRWorker
    from ..apps.linear.fm import FMWorker
    from ..parameter.kv_map import AddEntry, AssignEntry, KVMap
    from .headline import SLOTS, ell_conf, make_batch

    dev = mesh.device
    s = mesh.server_index
    batches = [make_batch(seed + 7000 + i) for i in range(steps)]
    out = {}
    for name, make in (("fm", lambda m: FMWorker(ell_conf(), k=8, seed=seed, mesh=m, device=dev)),
                       ("deep_ctr", lambda m: DeepCTRWorker(ell_conf(), k=8, hidden=(64, 32),
                                                            seed=seed, mesh=m, device=dev))):
        res = []
        for m in (mesh, None):
            reset_launches()
            w = make(m)
            _sync(dev)
            t0 = time.perf_counter()
            for b in batches:
                w.collect(w.process_minibatch(b))
            _sync(dev)
            res.append(dict(state=w.state_host()["state"], objective=list(w.progress.objective),
                            launches=launches()["segment_sum"], wall_s=time.perf_counter() - t0))
            w.executor.stop()
        mine, one = res
        table = (lambda st: st["table"]) if name == "deep_ctr" else (lambda st: st)
        rows = table(mine["state"])["w"].shape[0]
        equal = all(np.array_equal(table(mine["state"])[k],
                                   table(one["state"])[k][s * rows:(s + 1) * rows])
                    for k in ("w", "w_ss", "v", "v_ss"))
        if name == "deep_ctr":
            equal = equal and all(np.array_equal(a, b) for a, b in
                                  zip(mine["state"]["mlp"], one["state"]["mlp"]))
        out[name] = dict(bit_equal=bool(equal), objective=mine["objective"],
                         one_card_objective=one["objective"], launches=mine["launches"],
                         wall_s=mine["wall_s"], one_card_wall_s=one["wall_s"])
    rng = np.random.default_rng(17)
    stream = [(b.indices, rng.normal(size=(b.nnz, 8)).astype(np.float32)) for b in batches[:2]]
    probe = np.concatenate([batches[0].indices[:50_000], rng.integers(0, 1 << 40, 10_000)])
    for entry in (AddEntry, AssignEntry):
        res = []
        for m in (mesh, None):
            reset_launches()
            kv = KVMap(entry(), k=8, num_slots=SLOTS, mesh=m, device=dev, name="kvmap")
            for keys, vals in stream:
                kv.wait(kv.push(kv.request(), keys, vals))
            res.append(dict(table=kv.get_replica()["value"], values=kv.values(probe),
                            launches=launches()["segment_sum"]))
            kv.executor.stop()
        mine, one = res
        out[f"kv_map_{entry.__name__}"] = dict(
            bit_equal=bool(mine["table"].tobytes() == one["table"].tobytes()
                           and mine["values"].tobytes() == one["values"].tobytes()),
            launches=mine["launches"], rows=int(mine["table"].shape[0]))
    return out


def ell_and_a10_meshes(cases: Sequence[tuple], seed: int, n_batches: int, a10_steps: int,
                       state: bool = True) -> dict:
    """Phase 9d's world of 4 ranks: each ELL case ``(num_data,
    num_server, wire, ministeps a launch, push filter bytes)`` of the
    headline conf on the dense route (a prefix of the world; the other
    ranks idle): the wire it took, the objective a launch, the kernel
    launches, the wall time, and (``state``) this rank's shard; then,
    with ``a10_steps``, :func:`_first_part` and :func:`_a10_one_by_two`
    on a ``1 x 2`` mesh."""
    from ..apps.linear.async_sgd import AsyncSGDWorker
    from ..convert import state_to_numpy

    out = {"cases": []}
    for d, s, wire, steps, push in cases:
        mesh = meshlib.make_mesh(d, s)
        if not mesh.active:
            out["cases"].append(None)
            continue
        batches = _ell_batches(wire, seed, n_batches)
        w = AsyncSGDWorker(_ell_conf(wire, steps, push), mesh=mesh)
        kind = type(w.prep(batches[0], device_put=False)).__name__
        reset_launches()
        _sync(mesh.device)
        t0 = time.perf_counter()
        obj = _objectives(w, batches, steps)
        _sync(mesh.device)
        rec = dict(coords=mesh.coords, kind=kind, objective=obj, launches=launches(),
                   wall_s=time.perf_counter() - t0, examples=sum(b.n for b in batches))
        if state:
            rec["state"] = state_to_numpy(w.state)
        # one launch more with each psum of the step timed alone
        calls = []
        with _timed_psums(mesh.device, calls):
            _objectives(w, batches[:steps], steps)
        rec["psums"] = calls
        w.remove()
        out["cases"].append(rec)
    if a10_steps:
        mesh = meshlib.make_mesh(1, 2)
        if mesh.active:
            out["first_part"] = _first_part(seed, 4, mesh)
            out["a10"] = _a10_one_by_two(seed, mesh, a10_steps)
            out["coords"] = mesh.coords
    return out


def nn_cli_and_psum(argvs: List[List[str]], psum_floats: int, reps: int) -> dict:
    """The NN CLI inside the world, once for each of ``argvs`` (each run's
    exit code and the rows rank 0 printed), then :func:`psum_ms` of
    ``psum_floats`` float32 over the world."""
    from ..apps.nn import main as nn_main

    runs = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = nn_main.main(argv)
        runs.append({"rc": rc, "out": buf.getvalue()})
    return {"runs": runs, "psum": psum_ms(psum_floats, reps)}
