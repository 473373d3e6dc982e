"""Serving CLI — stand up the request-path frontend over a live table
(and optionally an LM) and drive it with open-loop Poisson load:

    python -m parameter_server_tpu_torch.apps.serve.main \\
        [--num-slots N] [--keys-per-request K] [--workers W] \\
        [--rate R | --rate-multiplier M] [--duration S] \\
        [--admission-rate R] [--max-queue-depth D] \\
        [--coalesce-window-ms MS] [--replica full|hot|off] \\
        [--train-while-serving] [--decode] [--gamma G] [--device cpu]

Counterpart of ``parameter_server_tpu/apps/serve/main.py`` on one card
(the CUDA device unless ``--device`` names another): the same flags,
defaults and JSON-line records. Inside a world a launcher started
(``PS_COORDINATOR_ADDRESS``, ``PS_NUM_PROCESSES``, ``PS_PROCESS_ID`` and
``PS_DEVICE`` on every rank, e.g. ``parallel/launch.run_world(main, N,
args=(argv,))``), every rank runs the CLI: the table is built on the
postoffice's auto-shaped mesh (``N x 1`` here, as the JAX CLI's over
every device), every rank pushes the warm keys, rank 0 calibrates,
serves, trains (``--train-while-serving`` pushes through the
frontend's order, ``parallel/sequence.py``), decodes and exposes the
metrics, and prints the records, while the other ranks follow its
store calls; at the end the ranks agree a digest of the table (the
last record carries it, with the mesh's shape). It fills a weight table (KVVector,
hashed directory) with a warm push from ``--seed``, wraps it in a
:class:`~parameter_server_tpu_torch.serving.ServeFrontend` (admission
control → worker pool → read replica → request coalescing), calibrates
the closed-loop capacity, and reports p50/p99/p99.9 + goodput for each
offered-load point.

``--train-while-serving`` streams pushes into the live table from a
background thread while the load runs. ``--decode`` adds a
speculative-decoding LM lane (``--draft trained`` first trains the
(target, draft) pair on a structured byte corpus with the port's
``make_lm_train_step``, so the acceptance rate means something);
``--batch-slots N`` serves it through the continuous batcher.
``--expose-port PORT`` serves the cluster metrics plane on
127.0.0.1:PORT while the CLI runs (``telemetry/exposition.py``; 0 picks
a free port, printed to stderr): ``/metrics``, ``/healthz`` and
``/debug/snapshot``, with the default SLO alert rules evaluating; a last
``serve_exposition`` record reports the endpoint and its health.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

WARM_KEYS = 1 << 14  # warm-push draws (distinct keys: fewer)
POOL = 512  # distinct requests in the pool


def _spec_corpus(rng):
    """The structured byte corpus: a 16-byte cycle with 10% uniform
    noise — regular enough that a tiny draft tracks the target, noisy
    enough that losses stay informative."""
    pat = np.tile(np.arange(97, 113, dtype=np.int32), 1 << 12)
    noise = rng.integers(0, 256, pat.size, np.int32)
    return np.where(rng.random(pat.size) < 0.1, noise, pat)


def _decode_models(draft: str, seed: int, device):
    """The decode lane's (target, draft) pair: random-init, or with
    ``draft="trained"`` both trained on :func:`_spec_corpus`."""
    from ...models.transformer import LMConfig, init_lm, make_lm_train_step

    tcfg = LMConfig(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128)
    dcfg = LMConfig(vocab=256, d_model=32, n_heads=2, n_layers=1, d_ff=64)
    tparams = init_lm(0, tcfg, device)
    dparams = init_lm(1, dcfg, device)
    info = {"draft": draft}
    if draft == "trained":
        rng = np.random.default_rng(seed)
        corpus = _spec_corpus(rng)
        seq = 64
        losses = {}
        for nm, cfg_i, p_i, lr_i, nst in (("target", tcfg, tparams, 0.2, 300),
                                          ("draft", dcfg, dparams, 0.4, 200)):
            step_i = make_lm_train_step(cfg_i, lr=lr_i)
            tl = None
            for _ in range(nst):
                starts = rng.integers(0, corpus.size - seq - 1, 8)
                toks = np.stack([corpus[s:s + seq + 1] for s in starts])
                p_i, tl = step_i(p_i, torch.from_numpy(toks).long().to(device))
            if not np.isfinite(float(tl)):
                raise RuntimeError(f"--draft trained: {nm} training diverged (loss={float(tl)})")
            losses[f"{nm}_loss"] = round(float(tl), 3)
            if nm == "target":
                tparams = p_i
            else:
                dparams = p_i
        info.update(losses)
    return tparams, tcfg, dparams, dcfg, info


def _decode_lane(gamma: int, models):
    """A speculative-decoding decode_fn (one sequential call a request)."""
    from ...models.speculative import speculative_generate

    tparams, tcfg, dparams, dcfg, _ = models

    def decode_fn(req):
        with torch.no_grad():
            return speculative_generate(tparams, tcfg, dparams, dcfg, req.prompt, req.steps,
                                        gamma=gamma, eos_id=req.eos_id)

    return decode_fn


def warm_store(num_slots: int, key_space: int, seed: int, device):
    """The served table and its request pool, as the CLI builds them:
    ``(kv, rng, pool)``. One push of ``WARM_KEYS`` draws (normal values)
    fills the table; ``pool`` holds ``POOL`` power-law key rows; ``rng``
    continues the seed's stream (the CLI's decode prompts read it)."""
    from ...parameter.kv_vector import KVVector

    kv = KVVector(k=1, num_slots=num_slots, hashed=True, name="serve_w", device=device)
    rng = np.random.default_rng(seed)
    warm = np.unique(rng.integers(0, key_space, WARM_KEYS))
    kv.wait(kv.push(kv.request(channel=0), keys=warm,
                    values=rng.normal(size=(len(warm), 1)).astype(np.float32)))
    return kv, rng


def request_pool(rng, keys_per_request: int, key_space: int) -> np.ndarray:
    u = rng.random((POOL, keys_per_request))
    return (u * u * u * key_space).astype(np.int64)  # power-law keys


def hot_set(pool: np.ndarray, hot_fraction: float, key_space: int) -> np.ndarray:
    """The hot replica's keys: the head of the request pool, most
    frequent first."""
    uniq, counts = np.unique(pool, return_counts=True)
    n_hot = max(1, min(len(uniq), int(hot_fraction * key_space)))
    return uniq[np.argsort(counts, kind="stable")[::-1][:n_hot]]


def _agree_table(kv, mesh) -> str:
    """Every rank's shard digest, agreed over each server column of the
    mesh (raises on every rank where two replicas of a shard differ);
    returns this rank's as hex."""
    from ...parallel import distributed
    from ...parallel import mesh as meshlib

    kv.executor.wait_all(pop=False)
    digest = distributed.batch_digest(kv.table(0))
    distributed.agree_on(mesh, [digest], ["the served table"], axes=(meshlib.DATA_AXIS,))
    return f"{digest:016x}"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-slots", type=int, default=1 << 18)
    ap.add_argument("--key-space", type=int, default=1 << 24)
    ap.add_argument("--keys-per-request", type=int, default=32)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load, requests/s (0 = calibrate)")
    ap.add_argument("--rate-multiplier", type=float, nargs="*", default=[0.25, 3.0],
                    help="offered-load points as multiples of the calibrated closed-loop "
                    "capacity (used when --rate is 0)")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--admission-rate", type=float, default=-1.0,
                    help="token-bucket accept rate (requests/s); -1 = 0.6x calibrated "
                    "capacity, 0 = no rate gate")
    ap.add_argument("--max-queue-depth", type=int, default=64)
    ap.add_argument("--coalesce-window-ms", type=float, default=2.0)
    ap.add_argument("--replica", default="full", choices=("full", "hot", "off"))
    ap.add_argument("--hot-fraction", type=float, default=0.01,
                    help="fraction of the key space snapshotted by the hot replica, capped "
                    "at the request pool's distinct keys (--replica hot)")
    ap.add_argument("--train-while-serving", action="store_true",
                    help="stream pushes into the live table while serving")
    ap.add_argument("--decode", action="store_true", help="add the speculative-decode LM lane")
    ap.add_argument("--draft", default="random", choices=("random", "trained"),
                    help="decode-lane model pair: random-init, or trained on the structured "
                    "corpus so acceptance means something")
    ap.add_argument("--batch-slots", type=int, default=0,
                    help="serve decode through the continuous batcher with this many slots "
                    "(0 = sequential decode_fn)")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--expose-port", type=int, default=None, metavar="PORT",
                    help="serve the cluster metrics plane while the CLI runs: /metrics "
                    "(node-labeled aggregate incl. the live ps_serve_* family), /healthz, "
                    "/debug/snapshot; the default SLO alert rules evaluate against this "
                    "process. 0 = ephemeral")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain path)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from ...parallel import sequence
    from ...system.postoffice import Postoffice

    Postoffice.reset()
    po = Postoffice.instance().start(device=args.device)
    device = po.device
    exposition = None
    if args.expose_port is not None and po.mesh.rank == 0:  # rank 0 serves in a world
        from ...telemetry.exposition import expose_cluster

        exposition = expose_cluster(po, port=args.expose_port, metrics_interval=1.0)
        print(f"serve: metrics exposed at {exposition.url}/metrics "
              f"(/healthz, /debug/snapshot)", file=sys.stderr)
    kv, rng = warm_store(args.num_slots, args.key_space, args.seed, device)
    pool = request_pool(rng, args.keys_per_request, args.key_space)

    # inside a world every rank builds one order of kv's calls here: rank 0
    # serves, calibrates and trains through it, the other ranks follow it,
    # and the ranks agree the table's digest at rank 0's last call
    order = sequence.Order(kv, name="serve") if sequence.needed(kv) else None
    if order is not None:
        order.handle("agree_table", lambda: _agree_table(kv, po.mesh))
        if not order.leader:
            try:
                order.follow()
            finally:
                kv.executor.stop()
                kv.remove()
            return 0
    store = kv if order is None else order
    try:
        return _lead(args, po, kv, store, pool, rng, exposition)
    finally:
        if order is not None:  # also after a failure: the followers return
            order.close()


def _lead(args, po, kv, store, pool, rng, exposition) -> int:
    """The CLI on one card, or on rank 0 of a world through ``store``,
    the order of ``kv``'s calls."""
    from ...serving import DecodeRequest, PullRequest, ServeConfig, ServeFrontend, open_loop_bench

    device = po.device

    def make_request(i: int):
        return PullRequest(keys=pool[i % len(pool)])

    hot_keys = (hot_set(pool, args.hot_fraction, args.key_space)
                if args.replica == "hot" else None)
    models = _decode_models(args.draft, args.seed, device) if args.decode else None

    def make_batcher():
        from ...serving import BatcherConfig, ContinuousBatcher

        tparams, tcfg, dparams, dcfg, _ = models
        return ContinuousBatcher(tparams, tcfg, dparams, dcfg,
                                 BatcherConfig(slots=args.batch_slots, max_prompt=64,
                                               max_new=64, gamma=args.gamma))

    def build(admission_rate: float) -> ServeFrontend:
        batched = args.decode and args.batch_slots > 0
        return ServeFrontend(
            store,
            ServeConfig(
                admission_rate=max(0.0, admission_rate),
                admission_burst=max(1.0, admission_rate / 10),
                max_queue_depth=args.max_queue_depth,
                coalesce_window_s=args.coalesce_window_ms / 1e3,
                replica=args.replica,
                hot_keys=hot_keys,
                workers=args.workers,
            ),
            decode_fn=(_decode_lane(args.gamma, models)
                       if models is not None and not batched else None),
            batcher=make_batcher() if batched else None,
        ).start()

    def emit(rec: dict) -> None:
        print(json.dumps(rec), flush=True)

    # calibrate capacity closed-loop
    fe = build(0.0)
    for i in range(10):
        fe.submit(make_request(i)).result(30)
    n_cal = 200
    t0 = time.perf_counter()
    for i in range(n_cal):
        fe.submit(make_request(i)).result(30)
    capacity = n_cal / (time.perf_counter() - t0)
    emit({"metric": "serve_closed_loop_capacity", "value": round(capacity, 1),
          "unit": "requests/sec", "replica": args.replica, "workers": args.workers})
    fe.close()

    admission = 0.6 * capacity if args.admission_rate < 0 else args.admission_rate
    fe = build(admission)

    stop_training = threading.Event()
    trainer, trainer_error = None, []
    if args.train_while_serving:
        def train_loop():
            i = 0
            try:
                while not stop_training.is_set():
                    keys = np.unique(pool[i % len(pool)])
                    store.wait(store.push(store.request(channel=0), keys=keys,
                                          values=np.ones((len(keys), 1), np.float32)))
                    i += 1
            except BaseException as e:  # re-raised on the main thread below
                trainer_error.append(e)

        trainer = threading.Thread(target=train_loop, name="serve-trainer", daemon=True)
        trainer.start()

    rates = [args.rate] if args.rate > 0 else [m * capacity for m in args.rate_multiplier]
    for rate in rates:
        rec = open_loop_bench(fe, make_request, rate=rate, duration_s=args.duration,
                              seed=args.seed, warmup_requests=5)
        rec["metric"] = "serve_open_loop_point"
        rec["admission_rate"] = round(admission, 1)
        rec["train_while_serving"] = bool(trainer)
        emit(rec)

    if args.decode:
        from ...serving import RejectedError

        def submit_decode(req, deadline_s: float = 30.0):
            # the overload points just drained the token bucket: honor
            # retry_after_s on the 429 instead of failing the CLI
            t_end = time.monotonic() + deadline_s
            while True:
                try:
                    return fe.submit(req)
                except RejectedError as e:
                    if time.monotonic() >= t_end:
                        raise
                    time.sleep(max(e.retry_after_s, 0.05))

        if args.draft == "trained":
            # prompts from the corpus the pair was trained on
            corpus = _spec_corpus(np.random.default_rng(args.seed))
            starts = rng.integers(0, corpus.size - 32, 4)
            prompt = np.stack([corpus[s:s + 32] for s in starts]).astype(np.int32)
        else:
            prompt = rng.integers(0, 256, (4, 32)).astype(np.int32)
        t = submit_decode(DecodeRequest(prompt=prompt, steps=32))
        t.result(600)  # first call: kernel builds, allocator warm-up
        lat = []
        for _ in range(3):
            t = submit_decode(DecodeRequest(prompt=prompt, steps=32))
            t.result(600)
            lat.append(t.latency_s())
        # acceptance measured on the served pair directly
        from ...models.speculative import speculative_generate

        tparams, tcfg, dparams, dcfg, draft_info = models
        with torch.no_grad():
            _, spec_stats = speculative_generate(tparams, tcfg, dparams, dcfg, prompt, 32,
                                                 gamma=args.gamma, return_stats=True)
        rec = {
            "metric": "serve_decode_latency_ms",
            "value": round(float(np.median(lat)) * 1e3, 1),
            "unit": "ms", "gamma": args.gamma,
            "tokens_per_request": int(prompt.shape[0]) * 32,
            "accepted_frac": round(float(spec_stats["accepted_frac"]), 3),
            **draft_info,
        }
        if args.batch_slots > 0:
            rec["batcher"] = fe.batcher.stats()
        emit(rec)

    if trainer is not None:
        stop_training.set()
        trainer.join(timeout=60)
        # the stream must run to the end of the window: a push that raised
        # or hung fails the CLI instead of leaving the table quietly still
        failed = trainer_error[0] if trainer_error else None
        if failed is not None or trainer.is_alive():
            fe.close()
            if failed is not None:  # a hung push would hold the executor's stop
                kv.executor.stop()
                kv.remove()
            raise RuntimeError("--train-while-serving: the push stream "
                               + ("failed" if failed else "did not stop within 60 s")) from failed
    stats = fe.stats()
    fe.close()
    mesh_rec = {}
    if store is not kv:
        mesh_rec = {"mesh": dict(po.mesh.shape), "table_digest": store.call("agree_table")}
    emit({"metric": "serve_frontend_stats", "value": 1, "unit": "ok", **stats, **mesh_rec})
    if exposition is not None:
        ok, health = exposition.aux.health()
        emit({"metric": "serve_exposition", "value": 1, "unit": "ok",
              "url": exposition.url, "healthz_ok": ok,
              "alerts_firing": health.get("alerts_firing", [])})
        from ...telemetry.exposition import close_cluster

        close_cluster(exposition)
    kv.executor.stop()
    kv.remove()  # unregister, so the table is freed with the last reference
    return 0


if __name__ == "__main__":
    sys.exit(main())
