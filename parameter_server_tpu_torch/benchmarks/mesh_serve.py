"""The serving plane over a mesh of ranks, measured.

Rank functions for ``parallel/launch.run_world`` (``chip_smoke.py``'s
phase 9f): every rank of a world runs one at the serve CLI's full width
(a hashed ``KVVector`` of 2^22 x 1 float32, the CLI's warm push of 2^14
keys drawn from 2^24), and the caller holds the results. On one card the
ranks share it and talk gloo, so each number here is of ranks sharing
one card over gloo, not of NCCL across cards.

- :func:`frontend_resize` (a world of 6): the JAX resize test's frontend
  (a full replica refreshed in the background, 2 workers, a queue of 64,
  3 client threads of 16-key requests) on the table at 2x2, resized to
  2x3 under traffic; then the resized table served with the replica off
  (coalesced collective pulls) and hot, against a one-process store fed
  the same push.
- :func:`cli_and_suite` (a world of 4): the serve CLI on every rank
  (``apps/serve/main.main``, the postoffice's 4 x 1 mesh), once a flag
  set, then the component suite's mesh probes (``learning`` and
  ``consistency`` on the JAX ``_learning_mesh()``, 2x2; the rest on
  ``_mesh()``, 4 x 1).

Each part counts its kernel launches from zero (the three flash kernels
too) and, with ``hold``, holds each kernel it launched to its plain
version on the part's first launch's inputs on this rank
(``benchmarks/mesh_apps.py``; ``flash_fwd`` within its float32
tolerance). Each serving part builds one ``parallel/sequence.Order`` of
its store on every rank: rank 0 serves through it and closes it, and the
other ranks follow it.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
import traceback
from typing import Dict, List, Sequence

import numpy as np
import torch

from .mesh import _sync
from .mesh_apps import _part

WARM_KEYS = 1 << 14  # the serve CLI's warm-push draws
KEY_SPACE = 1 << 24  # the serve CLI's default key space
#: the flash forward's float32 tolerance (rtol, atol), as chip_smoke.py holds it
FLASH_F32_TOL = (0.0, 2e-5)


class ServeStoreWorker:
    """An elastic worker holding the served table: a hashed ``KVVector``
    of ``num_slots`` x 1 and the state hooks ``system/elastic.py`` drives
    (the configured modulus keeps every key's slot across server
    counts)."""

    def __init__(self, mesh, num_slots: int):
        from ..parameter.kv_vector import KVVector

        self.kv = KVVector(mesh=mesh, k=1, num_slots=num_slots, hashed=True, name="serve_w")
        self.executor = self.kv.executor
        self.num_slots = self.kv.num_slots

    def state_host(self) -> dict:
        self.kv.executor.wait_all(pop=False)
        return {"state": {"table": self.kv.table(0).cpu().numpy().copy()},
                "seed_counter": np.int64(0)}

    def load_state_host(self, snap: dict) -> None:
        self.kv.table(0).copy_(torch.from_numpy(snap["state"]["table"]))

    def recover_server_shard(self, rank: int) -> bool:
        return False


def _warm(seed: int):
    """The serve CLI's warm push from ``seed``: its keys and values."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, KEY_SPACE, WARM_KEYS))
    return keys, rng.normal(size=(len(keys), 1)).astype(np.float32), rng


def _flash_kernels() -> dict:
    from ..ops import flash_attention as fa

    return {"flash_fwd": fa.flash_attention, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv}


@contextlib.contextmanager
def _counted(rec: dict, name: str, device: torch.device, hold: bool):
    """``mesh_apps._part`` with the flash kernels' launches too, each
    counted from zero at the part's start."""
    kernels = _flash_kernels()
    for fn in kernels.values():
        fn.launches = 0
    with _part(rec, name, device, hold) as out:
        yield out
    rec[name]["launches"].update({k: int(fn.launches) for k, fn in kernels.items()})


def _refresh_ms(fe, n: int = 3) -> List[float]:
    """``n`` replica refreshes on rank 0, each a sequenced whole-table
    snapshot (the data row's shards gathered over the server axis)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fe.replica.refresh()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _traffic(fe, keys, expect, outcomes: dict, errors: list):
    """3 client threads of 16-key requests over ``keys`` until the
    returned event is set: ok (bit-equal to ``expect``) / shed / wrong
    counted into ``outcomes``, anything else raised into ``errors``."""
    from ..serving import PullRequest, RejectedError

    stop = threading.Event()
    lock = threading.Lock()

    def client(c: int) -> None:
        i = c * 997
        while not stop.is_set():
            lo = i % (len(keys) - 16)
            try:
                got = fe.submit(PullRequest(keys=keys[lo:lo + 16])).result(timeout=60)
                same = np.array_equal(got.view(np.uint32), expect[lo:lo + 16].view(np.uint32))
                kind = "ok" if same else "wrong"
            except RejectedError:
                kind = "shed"
            except BaseException:  # noqa: BLE001 — the contract is none
                with lock:
                    errors.append(traceback.format_exc())
                return
            with lock:
                outcomes[kind] += 1
            i += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    return stop, threads


def _lead_or_follow(order, body) -> None:
    """``body()`` on rank 0, then ``order`` closed (also after a
    failure, so the followers return); every other rank follows it."""
    if not order.leader:
        order.follow()
        return
    try:
        body()
    finally:
        order.close()


def frontend_resize(seed: int, num_slots: int, phase_s: float, requests: int,
                    hold: bool = True) -> dict:
    """Phase 9f(a) on this rank of a world of 6 (module docstring)."""
    from ..parallel import distributed, sequence
    from ..parallel import mesh as meshlib
    from ..parameter.kv_vector import KVVector
    from ..serving import PullRequest, ServeConfig, ServeFrontend
    from ..system.elastic import ElasticCoordinator
    from ..system.postoffice import Postoffice
    from ..apps.serve.main import hot_set, request_pool

    device = distributed.rank_device()
    rec: Dict[str, object] = {"rank": torch.distributed.get_rank(), "device": str(device)}
    keys, vals, rng = _warm(seed)
    pool = request_pool(rng, 32, KEY_SPACE)[:requests]
    Postoffice.reset()
    co = ElasticCoordinator(lambda mesh: ServeStoreWorker(mesh, num_slots), num_data=2,
                            num_server=2)
    with _counted(rec, "resize", device, hold) as out:
        w = co.start()
        kv = None if w is None else w.kv
        if kv is not None:
            kv.wait(kv.push(kv.request(channel=0), keys=keys, values=vals))
        order = sequence.Order(kv, name="serve")
        co.serve_in(order)

        def serve_across_resize() -> None:
            fe = ServeFrontend(order, ServeConfig(replica="full", workers=2, max_queue_depth=64,
                                                  replica_refresh_s=0.01))
            expect = order.values(0, keys)
            fe.start()
            before = {"ok": 0, "shed": 0, "wrong": 0}
            errors: list = []
            stop, threads = _traffic(fe, keys, expect, before, errors)
            try:
                time.sleep(phase_s)
                fe.pause()
                fe.quiesce()
                at_pause = dict(before)
                refresh_2x2 = _refresh_ms(fe)
                w = co.resize(num_server=3)
                fe.rebind(w.kv)
                refresh_2x3 = _refresh_ms(fe)
                fe.resume()
                time.sleep(phase_s)
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=60)
                fe.close()
            after_values = order.values(0, keys)
            out.update(outcomes_before=at_pause,
                       outcomes_after={k: before[k] - at_pause[k] for k in before},
                       errors=errors, pause_s=co.resize_history[-1]["pause_s"],
                       history=[(h["old"], h["new"]) for h in co.resize_history],
                       refresh_ms={"2x2": refresh_2x2, "2x3": refresh_2x3},
                       values_equal=bool(np.array_equal(after_values.view(np.uint32),
                                                        expect.view(np.uint32))),
                       values_head=after_values[:4, 0].tolist(), keys=len(keys),
                       replica_nbytes=fe.stats()["replica"]["nbytes"])

        _lead_or_follow(order, serve_across_resize)
        _sync(device)
    # the resized table served with the replica off and hot
    worker = co.worker
    kv = None if worker is None else worker.kv
    hot = hot_set(pool, 0.01, KEY_SPACE)
    for mode in ("off", "hot"):
        with _counted(rec, f"serve_{mode}", device, hold) as out:
            order = sequence.Order(kv, name=f"serve_{mode}")

            def serve_pool() -> None:
                fe = ServeFrontend(order, ServeConfig(
                    replica=mode, workers=2, coalesce_window_s=0.002,
                    hot_keys=hot if mode == "hot" else None)).start()
                try:
                    t0 = time.perf_counter()
                    tickets = [fe.submit(PullRequest(keys=row)) for row in pool]
                    got = np.stack([t.result(120) for t in tickets])
                    out.update(values=got, seconds=time.perf_counter() - t0,
                               coalescer=fe.stats()["coalescer"], degraded=fe.degraded_served)
                finally:
                    fe.close()

            _lead_or_follow(order, serve_pool)
    if rec["rank"] == 0:  # the one-process store fed the same push, on the CPU
        one = KVVector(mesh=meshlib.Mesh(1, 1, "cpu"), device="cpu", k=1, num_slots=num_slots,
                       hashed=True, name="serve_one")
        one.wait(one.push(one.request(channel=0), keys=keys, values=vals))
        want = np.stack([one.values(0, row) for row in pool])
        one.executor.stop()
        for mode in ("off", "hot"):
            part = rec[f"serve_{mode}"]
            part["bit_equal_one_process"] = bool(np.array_equal(part["values"].view(np.uint32),
                                                                want.view(np.uint32)))
            part["nonzero_rows"] = int((part.pop("values") != 0).any(axis=(1, 2)).sum())
    rec["mesh_after"] = None if worker is None else dict(worker.kv.mesh.shape)
    rec["coords_after"] = Postoffice.instance().mesh.coords
    if worker is not None:
        rec["table_digest"] = distributed.batch_digest(worker.kv.table(0))
        worker.executor.stop()
    Postoffice.reset()
    return rec


@contextlib.contextmanager
def _flash_first():
    """The first ``flash_fwd`` launch's inputs in the block (tensors
    cloned): ``launch_kernel`` counts on ``flash_attention``, not on
    itself, so the counts are untouched."""
    from ..ops import flash_attention as fa

    orig = fa.launch_kernel
    seen: list = []

    def wrapper(*args, **kw):
        if not seen:
            seen.append(([a.detach().clone() if isinstance(a, torch.Tensor) else a
                          for a in args], dict(kw)))
        return orig(*args, **kw)

    fa.launch_kernel = wrapper
    try:
        yield seen
    finally:
        fa.launch_kernel = orig


@contextlib.contextmanager
def _segment_first():
    """The first ``segment_sum`` kernel launch's inputs in the block
    (``launch_kernel``: the sorted or presorted values and ids, cloned),
    for the sums that no store or worker hook records (the SpMV of
    ``sparse_matrix``); ``launch_kernel`` counts on ``segment_sum``, not
    on itself."""
    from ..ops import segment_sum as seg

    orig = seg.launch_kernel
    seen: list = []

    def wrapper(data, ids, num):
        if not seen:
            seen.append((data.detach().clone(), ids.detach().clone(), int(num)))
        return orig(data, ids, num)

    seg.launch_kernel = wrapper
    try:
        yield seen
    finally:
        seg.launch_kernel = orig


def _hold_segment(seen) -> float:
    """The segment_sum kernel against its plain version (each run summed
    in entry order on the CPU) on the recorded launch's inputs: raises
    unless bit-equal; returns the max |diff| (0.0)."""
    from ..ops import segment_sum as seg

    data, ids, num = seen[0]
    before = seg.segment_sum.launches
    got = seg.launch_kernel(data, ids, num).cpu()
    seg.segment_sum.launches = before  # the comparison's launch is not the path's
    want = seg.segment_sum_runs_ref(data.cpu(), ids.cpu().long(), num)
    if not torch.equal(got, want):
        raise RuntimeError(f"segment_sum on a 9f launch's inputs differs from its plain version "
                           f"(max |diff| {float((got - want).abs().max())})")
    return 0.0


def _hold_flash(seen) -> dict:
    """flash_fwd against its plain version on the recorded inputs: raises
    past ``FLASH_F32_TOL`` (float32; other types are not launched here)."""
    from ..ops import flash_attention as fa

    (q, k, v, q_off, k_off), kw = seen[0]
    before = fa.flash_attention.launches
    out, lse = fa.launch_kernel(q, k, v, q_off, k_off, **kw)
    fa.flash_attention.launches = before  # the comparison's launch is not the path's
    plain, plain_lse = fa._flash_plain(q, k, v, q_off, k_off, kw["causal"], kw["window"],
                                       kw["group"])
    rtol, atol = FLASH_F32_TOL
    err = float((out.float() - plain.float()).abs().max())
    lse_err = float((lse.float() - plain_lse.float()).abs().max())
    bound = atol + rtol * float(plain.float().abs().max())
    if q.dtype != torch.float32 or err > bound or lse_err > atol:
        raise RuntimeError(f"flash_fwd on a 9f launch's inputs ({q.dtype}): out {err}, lse "
                           f"{lse_err} past {FLASH_F32_TOL}")
    return dict(bh=q.shape[0], sq=q.shape[1], d=q.shape[2], max_abs_err=err, lse_err=lse_err)


def cli_and_suite(argvs: Sequence[List[str]], names: Sequence[str], smoke: Sequence[str],
                  hold: bool = True) -> dict:
    """Phase 9f(b) and (c) on this rank of a world of 4 (module
    docstring): each CLI run's records (rank 0's), launches and holds,
    then each probe's record, lines (rank 0's), launches and holds."""
    from ..apps.serve import main as serve_main
    from ..benchmarks import REGISTRY
    from ..benchmarks.__main__ import reset_process_state
    from ..parallel import distributed

    device = distributed.rank_device()
    rank = torch.distributed.get_rank()
    rec: Dict[str, object] = {"rank": rank, "device": str(device), "cli": [], "suite": {}}
    for argv in argvs:
        part: dict = {}
        buf = io.StringIO()
        with _counted(part, "run", device, hold) as out:
            with contextlib.redirect_stdout(buf):
                out["code"] = serve_main.main(list(argv))
        run = part["run"]
        run["records"] = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        run["argv"] = list(argv)
        rec["cli"].append(run)
    for name in names:
        reset_process_state()
        part = {}
        buf = io.StringIO()
        with _flash_first() as flash_seen, _segment_first() as seg_seen:
            with _counted(part, "run", device, hold) as out:
                with contextlib.redirect_stdout(buf):
                    out["record"] = REGISTRY[name](name in smoke, device=device)
        run = part["run"]
        if hold and device.type == "cuda":
            if flash_seen:
                run.setdefault("held", {})["flash_fwd"] = _hold_flash(flash_seen)
            if seg_seen and "segment_sum" not in run.get("held", {}):
                run.setdefault("held", {})["segment_sum"] = _hold_segment(seg_seen)
        run["lines"] = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        run["record"] = json.loads(json.dumps(run["record"], default=str))
        rec["suite"][name] = run
        reset_process_state()
    return rec
