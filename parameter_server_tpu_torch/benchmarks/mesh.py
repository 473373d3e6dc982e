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
