#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every kernel.

Run from the root of a checkout, on a machine with a CUDA device and
the CUDA toolkit:

    python3 chip_smoke.py [--seed N] [--timed-launches N]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: both CUDA kernels from ``parameter_server_tpu_torch/kernels/csrc``
   into ``build/torch_kernels/``;
3. kernel parity: each kernel against its plain PyTorch version on the
   card, bit for bit (the kernels are built with ``--fmad=false``), at the
   main path's shapes, with CUDA-event times and the HBM-byte bound;
4. main path: the port's ``AsyncSGDWorker`` trains the headline
   configuration (2^22-slot FTRL sparse logistic regression, 16384-row
   minibatches of 39 binary features, keys from 2^24, T=8 minibatches per
   launch) through the sparse kernel, then 8 dense ministeps through the
   dense kernel and 8 sparse ministeps with bf16 sqrt_n. Launch counters
   are zeroed before each path and read after it. The first 2 ministeps
   of each configuration are held against the same worker on the CPU
   (and run twice on the card, to report run-to-run determinism), and
   ``evaluate`` answers a held-out batch;
5. a ``{"kernels": [...]}`` line: each kernel's launches, parity and times;
6. the last line: ``{"ok": true, "device": {...}}``.

Every time printed is measured on the card in this run. Full records go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from parameter_server_tpu_torch import kernels  # noqa: E402
from parameter_server_tpu_torch.apps.linear.async_sgd import (  # noqa: E402
    AsyncSGDWorker,
    prep_batch_shared,
    stack_prepped_batches,
)
from parameter_server_tpu_torch.benchmarks.headline import (  # noqa: E402
    ALPHA,
    BETA,
    L1,
    MB,
    SLOTS,
    T,
    conf,
    make_batch,
)
from parameter_server_tpu_torch.ops import ftrl, ftrl_sparse  # noqa: E402
from parameter_server_tpu_torch.ops.kv_ops import localize  # noqa: E402
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory  # noqa: E402

BIG_SLOTS = 1 << 26  # the real-data table of bench.py --real
FTRL_KW = dict(alpha=ALPHA, beta=BETA, l1=L1, l2=0.0)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FTRL_FLOPS = 22  # arithmetic operations of one FTRL-proximal step
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)  # CUDA atomics reorder the sums
REPS, WARMUP = 20, 3

_flush_buf = None


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def flush_l2() -> None:
    """Write 256 MB so the 50 MB L2 holds nothing of the timed inputs:
    the main path runs other kernels between two FTRL updates."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.fill_(1)


def median_ms(fn) -> float:
    """Median device time of ``fn`` over REPS launches (CUDA events),
    each on a cold L2, after WARMUP untimed launches."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def compare(kernel_out, plain_out, what: str) -> float:
    """Bit equality of kernel and plain results; returns max |diff|."""
    torch.cuda.synchronize()
    err = 0.0
    for k, p in zip(kernel_out, plain_out):
        err = max(err, float((k.float() - p.float()).abs().max()))
        check(torch.equal(bits(k), bits(p)), f"{what}: kernel differs from plain (max |diff| {err})")
    return err


# -- phase 3: kernel parity at main-path shapes --


def dense_case(p: int, n_dtype, masked: bool, seed, gen) -> dict:
    dev = "cuda"
    z0 = torch.randn(p, device=dev, generator=gen)
    n0 = (torch.rand(p, device=dev, generator=gen) * 2).to(n_dtype)
    g = torch.randn(p, device=dev, generator=gen)
    # the dense step's gradient: a batch touches ~19% of a 2^22 table
    g[torch.rand(p, device=dev, generator=gen) > 0.19] = 0.0
    touched = None
    if masked:
        touched = (g != 0) | (torch.rand(p, device=dev, generator=gen) < 0.05)
    zk, nk, zr, nr = z0.clone(), n0.clone(), z0.clone(), n0.clone()
    ftrl.ftrl_update(zk, nk, g, touched, **FTRL_KW, seed=seed)
    ftrl.ftrl_update_ref(zr, nr, g, touched, **FTRL_KW, seed=seed)
    name = f"dense P=2^{p.bit_length() - 1} {'bf16' if n_dtype == torch.bfloat16 else 'f32'}" \
        f"{' mask' if masked else ''}{' seed' if seed is not None else ''}"
    err = compare((zk, nk), (zr, nr), name)
    keep = touched if masked else g != 0
    check(bool((zk != z0)[g != 0].float().mean() > 0.9), f"{name}: kernel left touched slots unchanged")
    check(torch.equal(zk[~keep], z0[~keep]), f"{name}: kernel wrote untouched slots")
    live = int(keep.sum())
    nb = n0.element_size()
    nbytes = p * 4 + (p if masked else 0) + live * (8 + 2 * nb)
    b_ms, b_by = bound(nbytes, live * FTRL_FLOPS)
    ms = median_ms(lambda: ftrl.ftrl_update(zk, nk, g, touched, **FTRL_KW, seed=seed))
    plain_ms = median_ms(lambda: ftrl.ftrl_update_ref(zr, nr, g, touched, **FTRL_KW, seed=seed))
    return dict(case=name, p=p, live=live, bytes=nbytes, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def sparse_inputs(seed: int, gen):
    """rel/ok of a real headline batch (localize of its deduplicated,
    padded slot vector, sentinel tail included) and a gradient on it."""
    batch = make_batch(seed)
    nnz_pad = max(4096, -(-int(batch.nnz * 1.25) // 4096) * 4096)
    uniq = -(-min(nnz_pad, SLOTS) // 1024) * 1024
    pb = prep_batch_shared(batch, KeyDirectory(SLOTS), 1, MB, nnz_pad, uniq, SLOTS)
    uslots = torch.as_tensor(pb.uslots[0]).cuda()
    rel, ok = localize(uslots, SLOTS)
    g_u = torch.randn(uniq, device="cuda", generator=gen) * torch.as_tensor(pb.umask[0]).cuda()
    return rel, ok, g_u


def sparse_case(n_dtype, seed, rel, ok, g_u, gen) -> dict:
    u = rel.numel()
    z0 = torch.randn(SLOTS, device="cuda", generator=gen)
    n0 = (torch.rand(SLOTS, device="cuda", generator=gen) * 2).to(n_dtype)
    zk, nk, zr, nr = z0.clone(), n0.clone(), z0.clone(), n0.clone()
    ftrl_sparse.ftrl_sparse_update(zk, nk, rel, ok, g_u, **FTRL_KW, seed=seed)
    ftrl_sparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g_u, **FTRL_KW, seed=seed)
    name = f"sparse P=2^{SLOTS.bit_length() - 1} U={u} {'bf16 seed' if n_dtype == torch.bfloat16 else 'f32'}"
    err = compare((zk, nk), (zr, nr), name)
    live_mask = ok & (g_u != 0)
    live = int(live_mask.sum())
    changed = torch.zeros(SLOTS, dtype=torch.bool, device="cuda")
    changed[rel[live_mask].long()] = True
    check(torch.equal(zk[~changed], z0[~changed]), f"{name}: kernel wrote a slot it does not own")
    check(int((~ok).sum()) > 0, f"{name}: no sentinel tail in the input")
    nb = n0.element_size()
    nbytes = u * (4 + 1 + 4) + live * (8 + 2 * nb)
    b_ms, b_by = bound(nbytes, live * FTRL_FLOPS)
    ms = median_ms(lambda: ftrl_sparse.ftrl_sparse_update(zk, nk, rel, ok, g_u, **FTRL_KW, seed=seed))
    plain_ms = median_ms(lambda: ftrl_sparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g_u, **FTRL_KW, seed=seed))
    return dict(case=name, p=SLOTS, u=u, live=live, bytes=nbytes, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# -- phase 4: the main path --


def reset_counts() -> None:
    ftrl.ftrl_update.launches = 0
    ftrl_sparse.ftrl_sparse_update.launches = 0


def counts():
    return ftrl_sparse.ftrl_sparse_update.launches, ftrl.ftrl_update.launches


def run_launch(worker, group):
    """One launch: a T-minibatch superbatch (sparse) or one minibatch."""
    if len(group) > 1:
        return worker.submit_superbatch(group, with_aux=False)
    return worker.process_minibatch(group[0], with_aux=False)


def assert_states_close(a: dict, b: dict, what: str) -> None:
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype == torch.bfloat16:
            d = (x.view(torch.int16).int() - y.view(torch.int16).int()).abs()
            check(int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3,
                  f"{what}: bf16 {k} beyond one ulp on 0.1%")
        else:
            check(torch.allclose(x, y, **TRAJ_TOL), f"{what}: {k} differs from the CPU run "
                  f"(max |diff| {float((x - y).abs().max())})")


def agree_with_cpu(update: str, dtype: str, batches) -> bool:
    """The first 2 ministeps on the card against the same port worker on
    the CPU (plain versions): metrics and state within the test
    tolerances. The card runs them twice; returns whether the two runs
    left bit-identical state (run-to-run determinism)."""
    what = f"{update} {dtype} first 2 ministeps vs CPU"
    workers = [AsyncSGDWorker(conf(update, dtype, 2), device=d) for d in ("cuda", "cuda", "cpu")]
    metrics = []
    for w in workers:
        ms = [run_launch(w, batches[:2])] if update == "sparse" else \
            [run_launch(w, [b]) for b in batches[:2]]
        metrics.append([{k: float(v) for k, v in m.items()} for m in ms])
    deterministic = all(torch.equal(bits(workers[0].state[k]), bits(workers[1].state[k]))
                        for k in workers[0].state)
    del workers[1], metrics[1]
    for mc, mh in zip(*metrics):
        check(mc["num_ex"] == mh["num_ex"], f"{what}: num_ex")
        check(abs(mc["objective"] - mh["objective"]) <= 1e-5 * abs(mh["objective"]), f"{what}: objective")
        for k in ("grad_sq", "update_sq", "weight_sq"):
            check(np.isclose(mc[k], mh[k], **TRAJ_TOL), f"{what}: {k} {mc[k]} vs {mh[k]}")
    assert_states_close(workers[0].state, workers[1].state, what)
    print(f"# agree: {what}: objective {metrics[0][-1]['objective']:.6f} (card) "
          f"{metrics[1][-1]['objective']:.6f} (CPU); two runs on the card bit-identical: "
          f"{deterministic}", flush=True)
    return deterministic


def headline(batches, timed: int) -> dict:
    """Warm-up launch plus ``timed`` launches of T=8 sparse ministeps."""
    worker = AsyncSGDWorker(conf("sparse"), device="cuda")
    check(worker.update_path == "cuda_sparse", f"update path {worker.update_path}")
    reset_counts()
    objectives = []
    m = run_launch(worker, batches[:T])
    objectives.append(float(m["objective"]) / float(m["num_ex"]))
    prep_s = upload_s = step_s = 0.0
    for k in range(1, timed + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group = batches[k * T:(k + 1) * T]
        prepped = stack_prepped_batches([worker.prep(b, device_put=False) for b in group])
        t1 = time.perf_counter()
        prepped = worker.upload(prepped)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        m = worker.submit(prepped, with_aux=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        prep_s += t1 - t0
        upload_s += t2 - t1
        step_s += t3 - t2
        obj = float(m["objective"])
        check(np.isfinite(obj) and float(m["num_ex"]) == T * MB, f"launch {k}: objective {obj}")
        objectives.append(obj / float(m["num_ex"]))
    sparse_n, dense_n = counts()
    check(sparse_n == T * (timed + 1) and dense_n == 0,
          f"headline launch counts sparse={sparse_n} dense={dense_n}, want {T * (timed + 1)}/0")
    ministeps = timed * T
    held_out = make_batch(10_000_000)
    ev = worker.evaluate(held_out)
    check(all(np.isfinite(v) for v in ev.values()), f"evaluate: {ev}")
    cpu = AsyncSGDWorker(conf("sparse"), device="cpu")
    cpu.load_state_host(worker.state_host())
    ev_cpu = cpu.evaluate(held_out)
    check(abs(ev["auc"] - ev_cpu["auc"]) <= 1e-4 and
          abs(ev["logloss"] - ev_cpu["logloss"]) <= 1e-5 * ev_cpu["logloss"],
          f"evaluate on the card {ev} vs CPU {ev_cpu}")
    return dict(
        sparse_launches=sparse_n, dense_launches=dense_n, ministeps_timed=ministeps,
        step_ms_per_ministep=step_s / ministeps * 1e3,
        upload_ms_per_ministep=upload_s / ministeps * 1e3,
        prep_ms_per_ministep=prep_s / ministeps * 1e3,
        examples_per_s_step=ministeps * MB / step_s,
        examples_per_s_e2e=ministeps * MB / (prep_s + upload_s + step_s),
        logloss_per_launch=objectives, evaluate=ev, evaluate_cpu=ev_cpu,
    )


def side_path(update: str, dtype: str, batches) -> dict:
    """8 ministeps of a second configuration, counted on their own."""
    worker = AsyncSGDWorker(conf(update, dtype), device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = [batches[:T]] if update == "sparse" else [[b] for b in batches[:T]]
    objs = [float(run_launch(worker, g)["objective"]) for g in groups]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sparse_n, dense_n = counts()
    want = (T, 0) if update == "sparse" else (0, T)
    check((sparse_n, dense_n) == want, f"{update} {dtype} launch counts {(sparse_n, dense_n)}, want {want}")
    check(all(np.isfinite(o) for o in objs), f"{update} {dtype}: objective {objs}")
    return dict(sparse_launches=sparse_n, dense_launches=dense_n,
                ms_per_ministep_with_prep=wall / T * 1e3, objective=objs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timed-launches", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)  # nvidia-smi: name, power.limit
    print(f"# device: {kind}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t_build = time.perf_counter()
    built = kernels.build_all()
    build_s = time.perf_counter() - t_build
    print(f"# build: {len(built)} CUDA kernels in {build_s:.1f} s "
          f"-> {kernels.BUILD_DIR}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    dense_rows = [
        dense_case(SLOTS, torch.float32, True, None, gen),
        dense_case(SLOTS, torch.float32, False, None, gen),
        dense_case(SLOTS, torch.bfloat16, False, 7, gen),
        dense_case(SLOTS, torch.bfloat16, True, 7, gen),
        dense_case(BIG_SLOTS, torch.float32, False, None, gen),
    ]
    rel, ok, g_u = sparse_inputs(args.seed + 1_000_000, gen)
    sparse_rows = [
        sparse_case(torch.float32, None, rel, ok, g_u, gen),
        sparse_case(torch.bfloat16, 7, rel, ok, g_u, gen),
    ]
    for r in dense_rows + sparse_rows:
        print(f"# parity {r['case']}: bit-equal; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes']} B, live {r['live']}) "
              f"[{smi}]", flush=True)

    batches = [make_batch(args.seed + i) for i in range(T * (args.timed_launches + 1))]
    deterministic = {
        f"{update} {dtype}": agree_with_cpu(update, dtype, batches)
        for update, dtype in (("sparse", "float32"), ("dense", "float32"), ("sparse", "bfloat16"))
    }
    head = headline(batches, args.timed_launches)
    print(f"# main path (card's own numbers, {smi}): sparse FTRL 2^22, T={T}: "
          f"{head['step_ms_per_ministep']:.3f} ms/ministep step, "
          f"{head['upload_ms_per_ministep']:.3f} ms/ministep upload, "
          f"{head['prep_ms_per_ministep']:.3f} ms/ministep host prep; "
          f"{head['examples_per_s_step']:.0f} ex/s step, {head['examples_per_s_e2e']:.0f} ex/s with prep; "
          f"logloss per launch {['%.5f' % x for x in head['logloss_per_launch']]}; "
          f"evaluate {head['evaluate']}", flush=True)
    dense = side_path("dense", "float32", batches)
    bf16 = side_path("sparse", "bfloat16", batches)
    print(f"# dense path: {dense['dense_launches']} dense launches, "
          f"{dense['ms_per_ministep_with_prep']:.3f} ms/ministep with prep", flush=True)
    print(f"# bf16 sparse path: {bf16['sparse_launches']} sparse launches, "
          f"{bf16['ms_per_ministep_with_prep']:.3f} ms/ministep with prep", flush=True)

    main_dense = dense_rows[1]  # f32, membership g != 0: what the dense step runs
    main_sparse = sparse_rows[0]
    kernel_line = {"kernels": [
        dict(name="ftrl_sparse_kernel", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/ftrl_sparse.cu",
             replaces="parameter_server_tpu/ops/ftrl_sparse.py:407",
             launches=head["sparse_launches"],
             max_abs_err=max(r["max_abs_err"] for r in sparse_rows),
             ms=main_sparse["ms"], plain_ms=main_sparse["plain_ms"],
             bound_ms=main_sparse["bound_ms"], bound_by=main_sparse["bound_by"],
             library_ms=None),
        dict(name="ftrl_dense_kernel", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/ftrl_dense.cu",
             replaces="parameter_server_tpu/ops/ftrl.py:265",
             launches=dense["dense_launches"],
             max_abs_err=max(r["max_abs_err"] for r in dense_rows),
             ms=main_dense["ms"], plain_ms=main_dense["plain_ms"],
             bound_ms=main_dense["bound_ms"], bound_by=main_dense["bound_by"],
             library_ms=None),
    ]}
    record = dict(nvidia_smi=smi, device=kind, torch=torch.__version__, cuda=torch.version.cuda,
                  build_seconds=build_s, parity=dense_rows + sparse_rows,
                  headline=head, dense_path=dense, bf16_path=bf16, kernels=kernel_line["kernels"],
                  run_to_run_deterministic=deterministic,
                  wall_s=time.perf_counter() - t_start)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"# wall {record['wall_s']:.1f} s", flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
