#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every kernel.

Run from the root of a checkout, on a machine with a CUDA device and
the CUDA toolkit:

    python3 chip_smoke.py [--seed N] [--timed-launches N]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``parameter_server_tpu_torch/kernels/csrc``
   (one library a source, all compiled at once) into ``build/torch_kernels/``;
3. kernel parity: each FTRL and quantize kernel against its plain PyTorch version on the
   card, bit for bit (the kernels are built with ``--fmad=false``), at the
   main paths' shapes, with CUDA-event times and the HBM-byte bound; the
   quantize kernel also against its statistical contract (round trip
   within one step, unbiased mean);
4. headline path: the port's ``AsyncSGDWorker`` trains the headline
   configuration (2^22-slot FTRL sparse logistic regression, 16384-row
   minibatches of 39 binary features, keys from 2^24, T=8 minibatches per
   launch) through the sparse kernel, then 8 dense ministeps through the
   dense kernel and 8 sparse ministeps with bf16 sqrt_n. The first 2
   ministeps of each configuration are held against the same worker on
   the CPU (and run twice on the card, to report run-to-run determinism),
   and ``evaluate`` answers a held-out batch;
5. CTR path: ``configs/ctr/online_l1lr.conf`` through the port's CLI
   (``parameter_server_tpu_torch.apps.linear.main``) on generated
   SPARSE_BINARY shards, with only its data files and model output
   pointed at a temporary directory: 2^22 slots, 10000-row minibatches,
   the 1-byte FIXING_FLOAT push filter (the quantize kernel and the
   masked dense kernel once per ministep), bounded delay 4, the count-min
   tail filter, the conf's 10 passes. Its first ministeps are held
   against the same CLI run on the CPU (objectives, pushed codes and
   weights); then a few ministeps with a FIXING_FLOAT pull filter added
   (two quantize launches per ministep);
6. LM serving (``benchmarks/lm_serve.py``: the ``doc/SERVING.md`` config,
   d_model 512, 8 heads of dim 64, 2 KV heads, 8 layers, d_ff 2048, bf16,
   int8 KV cache, random weights from the seed): the ``flash_fwd``
   kernel against its plain version at the prefill shape (B*H 64, S 2048,
   D 64, bf16, causal, K/V grouped by 4) and at D 128, float32, window
   1024, offsets with Sq != Sk and a ragged Sk tail, within the stated
   tolerance, with CUDA-event times beside the plain version, SDPA and
   the FLOP bound; ``lm_generate`` greedy at batch 8, 2048-token prompts,
   256 steps (time to first token, decode tokens/s, 8 flash launches a
   prefill), then with the documented sampling options; agreement with
   the plain attention on the card (teacher-forced logits at full size,
   greedy tokens) and with the port on the CPU (one row, 256-token
   prompt, 32 steps), to a tolerance set from the config's own bf16
   noise as the JAX reference shows it (``tests/torch_lm_bf16_noise.py``); ``speculative_generate`` greedy with the draft of
   ``script/onchip.py`` (gamma 4), its tokens against the greedy run's;
7. LM training (``benchmarks/lm_train.py``: the JAX package's byte-LM
   training shape, d_model 512, 8 heads of dim 64, 8 layers, d_ff 2048,
   bf16, remat, ``ring_flash``, SGD at lr 0.3, batch 4 x 8192 tokens, 8
   steps a launch, random weights and tokens from the seed): the
   backward kernels ``flash_bwd_dq`` and ``flash_bwd_dkv`` through the
   autograd Function against their plain version at the training shape
   cut to B*H 8 (S 8192, D 64, bf16, causal) and at D 128, float32,
   window 1024, GQA 4, offsets with Sq != Sk, a ragged Sk tail and a
   nonzero lse gradient, within the stated tolerances and bit-identical
   run to run; their CUDA-event times at B*H 32 beside the plain
   backward, SDPA's backward and the FLOP bound, and ``flash_fwd`` beside
   SDPA's forward at that shape; ``make_lm_train_step`` at
   the full config (a warm-up launch and 3 timed launches of 8 steps:
   tokens/s, step ms, MFU; flash launches asserted: 16 forward, 8 of each
   backward kernel a step); one step's loss and gradients against the same
   step with the plain attention on the card (batch 1, 2048 tokens),
   within 3x the JAX reference's own bf16-vs-f32 gaps
   (``tests/torch_lm_train_bf16_noise.py``); the LM CLI
   (``parameter_server_tpu_torch.apps.lm.main``) at 2 layers, d_model 64,
   on the card against ``--device cpu``, then at the full config for 30
   Adam steps to a falling loss and a 64-token generation;
8. a ``{"kernels": [...]}`` line: each kernel's launches, parity and times;
9. the last line: ``{"ok": true, "device": {...}}``.

Launch counters are zeroed before each path and read after it. Every
time printed is measured on the card in this run. Full records go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from parameter_server_tpu_torch import kernels  # noqa: E402
from parameter_server_tpu_torch.apps.linear import async_sgd  # noqa: E402
from parameter_server_tpu_torch.apps.linear import main as linear_main  # noqa: E402
from parameter_server_tpu_torch.apps.linear.async_sgd import (  # noqa: E402
    AsyncSGDWorker,
    prep_batch_shared,
    stack_prepped_batches,
)
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, write_ctr_shards  # noqa: E402
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
from parameter_server_tpu_torch.apps.lm import main as lm_main  # noqa: E402
from parameter_server_tpu_torch.benchmarks import lm_serve, lm_train  # noqa: E402
from parameter_server_tpu_torch.filter import fixing_float  # noqa: E402
from parameter_server_tpu_torch.learner.sgd import MinibatchReader  # noqa: E402
from parameter_server_tpu_torch.models import speculative, transformer  # noqa: E402
from parameter_server_tpu_torch.ops import flash_attention as fa  # noqa: E402
from parameter_server_tpu_torch.ops import ftrl, ftrl_sparse, quantize  # noqa: E402
from parameter_server_tpu_torch.ops.kv_ops import localize  # noqa: E402
from parameter_server_tpu_torch.parameter.parameter import KeyDirectory  # noqa: E402

BIG_SLOTS = 1 << 26  # the real-data table of bench.py --real
FTRL_KW = dict(alpha=ALPHA, beta=BETA, l1=L1, l2=0.0)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
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


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
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


def dense_case(p: int, n_dtype, masked: bool, seed, gen, frac: float = 0.19,
               extra: float = 0.05) -> dict:
    """``frac``: the share of slots a batch touches (a headline batch
    ~19% of a 2^22 table; the CTR path's is measured from its data);
    ``extra``: the share the mask adds where the gradient is zero (the
    CTR step's mask is exactly ``g != 0``)."""
    dev = "cuda"
    z0 = torch.randn(p, device=dev, generator=gen)
    n0 = (torch.rand(p, device=dev, generator=gen) * 2).to(n_dtype)
    g = torch.randn(p, device=dev, generator=gen)
    g[torch.rand(p, device=dev, generator=gen) > frac] = 0.0
    touched = None
    if masked:
        touched = (g != 0) | (torch.rand(p, device=dev, generator=gen) < extra)
    zk, nk, zr, nr = z0.clone(), n0.clone(), z0.clone(), n0.clone()
    ftrl.ftrl_update(zk, nk, g, touched, **FTRL_KW, seed=seed)
    ftrl.ftrl_update_ref(zr, nr, g, touched, **FTRL_KW, seed=seed)
    name = f"dense P=2^{p.bit_length() - 1} {'bf16' if n_dtype == torch.bfloat16 else 'f32'}" \
        f"{' mask' if masked else ''}{' seed' if seed is not None else ''} touched {frac:.3f}"
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
    quantize.quantize.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def counts():
    """(sparse FTRL, dense FTRL, quantize) kernel launches since the reset."""
    return (ftrl_sparse.ftrl_sparse_update.launches, ftrl.ftrl_update.launches,
            quantize.quantize.launches)


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
    sparse_n, dense_n, quant_n = counts()
    check((sparse_n, dense_n, quant_n) == (T * (timed + 1), 0, 0),
          f"headline launch counts sparse={sparse_n} dense={dense_n} quantize={quant_n}, "
          f"want {T * (timed + 1)}/0/0")
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
    sparse_n, dense_n, quant_n = counts()
    want = (T, 0, 0) if update == "sparse" else (0, T, 0)
    check((sparse_n, dense_n, quant_n) == want,
          f"{update} {dtype} launch counts {(sparse_n, dense_n, quant_n)}, want {want}")
    check(all(np.isfinite(o) for o in objs), f"{update} {dtype}: objective {objs}")
    return dict(sparse_launches=sparse_n, dense_launches=dense_n,
                ms_per_ministep_with_prep=wall / T * 1e3, objective=objs)


# -- phase 3b: the quantize kernel --

QUANT_P = 1 << 22  # the CTR conf's table: the push quantizes the whole shard
# arithmetic of one element: 9 f32 operations (sub, div, mul, convert,
# scale, add, floor, two clamps) and 12 integer ones (the hash)
QUANT_OPS = 21


def quantize_case(p: int, nb: int, seed: int, gen, frac: float = 0.05, zero: bool = False) -> dict:
    """Kernel against plain codes, bit for bit, on a pushed-gradient-like
    input (``frac`` of the entries nonzero) or on zeros; then the
    statistical contract of the codes."""
    x = torch.zeros(p, device="cuda")
    if not zero:
        x = torch.randn(p, device="cuda", generator=gen)
        x[torch.rand(p, device="cuda", generator=gen) > frac] = 0.0
    lo, hi = fixing_float.quantize_range(x)
    qk = quantize.launch_kernel(x, lo, hi, seed, nb)
    qp = fixing_float.quantize_codes(x, lo, hi, seed, nb)
    name = f"quantize P={p} b={nb} seed={seed}{' zeros' if zero else ''}"
    torch.cuda.synchronize()
    err = float((qk.to(torch.int32) - qp.to(torch.int32)).abs().max())
    check(torch.equal(qk.view(torch.uint8), qp.view(torch.uint8)), f"{name}: kernel codes differ from plain (max {err})")
    qw, low, hiw = quantize.quantize(x, seed, nb)
    check(torch.equal(qw.view(torch.uint8), qk.view(torch.uint8)) and float(low) == float(lo)
          and float(hiw) == float(hi), f"{name}: the wrapper differs from its parts")
    back = quantize.dequantize(qk, lo, hi, nb)
    lo_f, hi_f = float(lo), float(hi)
    step = (hi_f - lo_f) / fixing_float.levels_of(nb)
    trip = float((back - x).abs().max())
    # one step, plus the f32 rounding of the three dequantize operations
    slack = 1e-6 * max(1.0, abs(lo_f), abs(hi_f), hi_f - lo_f)
    check(trip <= step + slack, f"{name}: round trip {trip} beyond one step {step}")
    # unbiased: the mean rounding error over P elements, decoded in f64
    # (the f32 decode's own rounding is systematic for the many equal
    # zeros), within 4 standard errors of the stochastic rounding (each
    # sd <= step / 2) plus the f32 resolution of the scaled value: its
    # division, multiply and noise add each round by up to half an ulp
    # of `levels`, the same for every equal input (0.6% of a step at b=2)
    levels = fixing_float.levels_of(nb)
    exact = qk.to(torch.int32).double() / levels * (hi_f - lo_f) + lo_f
    bias = float((exact - x.double()).mean()) / step
    se = 1 / (2 * p ** 0.5)
    resolution = 1.5 * 2.0 ** (math.floor(math.log2(levels)) - 23)
    check(abs(bias) <= 4 * se + resolution,
          f"{name}: mean rounding error {bias:.3g} steps > 4 se {4 * se:.3g} + f32 {resolution:.3g}")
    if zero:
        check(torch.equal(back, x), f"{name}: zeros do not decode to zeros")
    return dict(case=name, p=p, nb=nb, seed=seed, max_abs_err=err, round_trip=trip, step=step,
                bias_steps=bias)


def quantize_times(p: int, nb: int, gen, frac: float) -> dict:
    x = torch.randn(p, device="cuda", generator=gen)
    x[torch.rand(p, device="cuda", generator=gen) > frac] = 0.0
    lo, hi = fixing_float.quantize_range(x)
    b_ms, b_by = bound(p * (4 + nb), p * QUANT_OPS)
    return dict(
        case=f"quantize P={p} b={nb}",
        ms=median_ms(lambda: quantize.launch_kernel(x, lo, hi, 5, nb)),
        plain_ms=median_ms(lambda: fixing_float.quantize_codes(x, lo, hi, 5, nb)),
        aminmax_ms=median_ms(lambda: fixing_float.quantize_range(x)),
        bound_ms=b_ms, bound_by=b_by, bytes=p * (4 + nb),
    )


# -- phase 5: the CTR conf through the CLI --

CTR_SHARDS, CTR_ROWS = 3, 30_000  # 9 minibatches of 10000 rows a pass
AGREE_ROWS = 70_000  # 7 ministeps: the last 3 pull a learned snapshot (τ = 4)
PULL_FILTER = "  pull_filter {\n    type: FIXING_FLOAT\n    num_bytes: 1\n  }\n"


@contextlib.contextmanager
def timed_cli():
    """Times the phases of a CLI run by wrapping the reader and worker
    methods it calls (host clock; upload and step end in a synchronize,
    so each holds its device work). Yields the record it fills."""
    rec = dict(parse_s=0.0, prep_s=0.0, upload_s=0.0, step_s=0.0, ministeps=0,
               examples=[], worker=None, slots=[])
    orig = dict(read=MinibatchReader.read, init=AsyncSGDWorker.__init__,
                prep=AsyncSGDWorker.prep, upload=AsyncSGDWorker.upload,
                submit=AsyncSGDWorker.submit)
    sync = torch.cuda.synchronize

    def read(self):
        t0 = time.perf_counter()
        out = orig["read"](self)
        rec["parse_s"] += time.perf_counter() - t0
        return out

    def init(self, *a, **k):
        orig["init"](self, *a, **k)
        rec["worker"] = self

    def prep(self, batch, device_put=True):
        t0 = time.perf_counter()
        out = orig["prep"](self, batch, device_put)
        rec["prep_s"] += time.perf_counter() - t0
        return out

    def upload(self, prepped):
        t0 = time.perf_counter()
        out = orig["upload"](self, prepped)
        sync()
        rec["upload_s"] += time.perf_counter() - t0
        return out

    def submit(self, prepped, with_aux=True):
        rec["examples"].append(prepped.num_examples)
        rec["slots"].append(prepped.slots)
        up0, t0 = rec["upload_s"], time.perf_counter()
        out = orig["submit"](self, prepped, with_aux)
        sync()
        rec["step_s"] += time.perf_counter() - t0 - (rec["upload_s"] - up0)
        rec["ministeps"] += 1
        return out

    patches = [(MinibatchReader, "read", read), (AsyncSGDWorker, "__init__", init),
               (AsyncSGDWorker, "prep", prep), (AsyncSGDWorker, "upload", upload),
               (AsyncSGDWorker, "submit", submit)]
    for cls, name, fn in patches:
        setattr(cls, name, fn)
    try:
        yield rec
    finally:
        MinibatchReader.read = orig["read"]
        for name in ("init", "prep", "upload", "submit"):
            setattr(AsyncSGDWorker, "__init__" if name == "init" else name, orig[name])


@contextlib.contextmanager
def recorded_wire():
    """Records, on the host, the codes, range and nonzero mask of every
    quantization the step's wire makes (its module's ``qops.quantize``;
    the kernel and its launch count are untouched). Yields the list it
    fills."""
    seen, qops = [], async_sgd.qops

    def quantize_rec(x, seed, num_bytes=1):
        q, lo, hi = qops.quantize(x, seed, num_bytes)
        seen.append((q.cpu(), float(lo), float(hi), (x != 0).cpu()))
        return q, lo, hi

    async_sgd.qops = types.SimpleNamespace(quantize=quantize_rec, dequantize=qops.dequantize)
    try:
        yield seen
    finally:
        async_sgd.qops = qops


def run_cli(conf_text: str, path: str, device: str) -> dict:
    """The port's CLI on a conf, as a user runs it; returns the timed record."""
    with open(path, "w") as f:
        f.write(conf_text)
    with timed_cli() as rec:
        t0 = time.perf_counter()
        rc = linear_main.main([path], device=device)
        rec["wall_s"] = time.perf_counter() - t0
    check(rc == 0, f"CLI on {path} ({device}) exited {rc}")
    w = rec["worker"]
    rec["objective"] = [o / e for o, e in zip(w.progress.objective, rec["examples"])]
    check(len(rec["objective"]) == rec["ministeps"] > 0 and all(np.isfinite(rec["objective"])),
          f"CLI on {path} ({device}): objective {rec['objective']}")
    return rec


def model_nonzeros(path: str) -> int:
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0].startswith("#hashed\t"), f"{path}: no #hashed header")
    vals = [float(line.split("\t")[1]) for line in lines[1:]]
    check(all(np.isfinite(v) and v != 0 for v in vals), f"{path}: a zero or non-finite weight")
    return len(vals)


def touched_share(rec: dict, num_slots: int) -> float:
    """The mean share of the table a ministep's batch touches (distinct
    owned slots over the table), over every batch the run submitted."""
    shares = []
    for slots in rec.pop("slots"):
        s = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots)
        shares.append(np.unique(s[s < num_slots]).size / num_slots)
    return float(np.mean(shares))


def ctr_path(tmp: str, seed: int) -> dict:
    """The CTR conf through the CLI on the card, every ministep counted."""
    write_ctr_shards(os.path.join(tmp, "train"), CTR_SHARDS, CTR_ROWS, seed)
    model = os.path.join(tmp, "model", "ctr_online")
    text = ctr_conf(os.path.join(tmp, "train", "part.*"), model)
    reset_counts()
    rec = run_cli(text, os.path.join(tmp, "ctr.conf"), "cuda")
    sparse_n, dense_n, quant_n = counts()
    n = rec["ministeps"]
    check((sparse_n, dense_n, quant_n) == (0, n, n),
          f"CTR launch counts sparse={sparse_n} dense={dense_n} quantize={quant_n}, want 0/{n}/{n}")
    worker = rec.pop("worker")
    check(worker.update_path == "cuda_dense" and worker.sgd.max_delay == 4,
          f"CTR worker: {worker.update_path}, max_delay {worker.sgd.max_delay}")
    touched = touched_share(rec, worker.num_slots)
    examples = sum(rec.pop("examples"))
    return dict(
        passes=worker.sgd.num_data_pass, ministeps=n, examples=examples, sparse_launches=sparse_n,
        dense_launches=dense_n, quantize_launches=quant_n, touched_frac=touched,
        parse_ms_per_ministep=rec["parse_s"] / n * 1e3, prep_ms_per_ministep=rec["prep_s"] / n * 1e3,
        upload_ms_per_ministep=rec["upload_s"] / n * 1e3, step_ms_per_ministep=rec["step_s"] / n * 1e3,
        wall_s=rec["wall_s"], examples_per_s_e2e=examples / rec["wall_s"],
        objective_first=rec["objective"][0], objective_last=rec["objective"][-1],
        model_nonzeros=model_nonzeros(model + "_S0"), num_slots=worker.num_slots,
    )


def ctr_agree_and_pull(tmp: str, seed: int) -> dict:
    """The CTR conf's first 7 ministeps (one pass over a 70000-row shard)
    on the card and on the CPU; both draw the same quantization noise.
    Then the same with a FIXING_FLOAT pull filter on the card: two
    quantize launches per ministep.

    What must agree, and how closely:
    - the first τ ministeps pull the zero table, so every row gradient
      is ±1/2 and each pushed shard gradient an exact sum: their codes
      and ranges are bit-equal;
    - later pushes are sums in another order (the card's atomics), so a
      code may differ by one, and the range by its last bits (a code
      counts where the pushed entry is nonzero: the wire zeroes the
      rest);
    - objectives within 1e-5 relative (the unfiltered agreement's bar):
      with τ = 4 all 7 forward passes read the zero table or the
      snapshot after the 4 exact ministeps, so only their sums' order
      differs;
    - weights within what the pushes' differences explain. A code one
      apart, or a shifted range, moves a decoded gradient by at most
      ``e = step * [codes differ] + 2 |Δlo| + |Δhi|``; from one such
      gradient, ``z`` moves by at most ``e (1 + |w|/α)`` and ``√n`` by
      ``e`` (tests/test_torch_filtered_wire.py); the weight
      ``-(z - λ1 sgn z) / ((β + √n)/α + λ2)`` moves by at most ``α/β``
      times the first and ``|w|/β`` times the second. So each weight
      within ``S (α + 2|w|) / β`` with ``S`` the sum of ``e`` over the
      ministeps, ``|w|`` the larger of the two runs', plus the last-bit
      tolerance (rtol 1e-5, atol 1e-6). With no code apart and equal
      ranges that is the last-bit tolerance alone."""
    write_ctr_shards(os.path.join(tmp, "agree"), 1, AGREE_ROWS, seed)
    data = os.path.join(tmp, "agree", "part.*")
    runs, pushes = {}, {}
    for dev in ("cuda", "cpu"):
        text = ctr_conf(data, os.path.join(tmp, f"agree_{dev}"), num_data_pass=1)
        with recorded_wire() as pushes[dev]:
            runs[dev] = run_cli(text, os.path.join(tmp, f"agree_{dev}.conf"), dev)
    oc, oh = runs["cuda"]["objective"], runs["cpu"]["objective"]
    n = AGREE_ROWS // 10_000
    check(len(oc) == len(oh) == len(pushes["cuda"]) == len(pushes["cpu"]) == n,
          f"CTR agree: ministeps {len(oc)}/{len(oh)}, pushes {len(pushes['cuda'])}/{len(pushes['cpu'])}")
    rel_gap = max(abs(a - b) / abs(b) for a, b in zip(oc, oh))
    check(rel_gap <= 1e-5, f"CTR first ministeps card {oc} vs CPU {oh}")
    check(oc[-1] < oc[0], f"CTR agree: the card's run did not learn {oc}")
    worker = runs["cpu"]["worker"]
    tau, levels = worker.sgd.max_delay, fixing_float.levels_of(1)
    codes_apart, e_sum = [], 0.0
    for t, ((qc, loc, hic, nzc), (qh, loh, hih, nzh)) in enumerate(zip(pushes["cuda"], pushes["cpu"])):
        check(torch.equal(nzc, nzh), f"CTR push {t}: the pushed support differs")
        d = (qc.int() - qh.int()).abs()
        apart = int(((d != 0) & nzh).sum())
        codes_apart.append(apart)
        if t < tau:
            check(torch.equal(qc, qh) and (loc, hic) == (loh, hih),
                  f"CTR push {t} on the zero table: {apart} codes apart, range {(loc, hic)} vs {(loh, hih)}")
        check(int(d.max()) <= 1, f"CTR push {t}: a code {int(d.max())} apart")
        step = max(hic - loc, hih - loh) / levels
        e_sum += step * (apart > 0) + 2 * abs(loc - loh) + abs(hic - hih)
    alpha, beta = worker.conf.learning_rate.alpha, worker.conf.learning_rate.beta
    wc = runs["cuda"]["worker"].weights_dense()
    wh = worker.weights_dense()
    w_abs = np.maximum(np.abs(wc), np.abs(wh))
    allowed = e_sum * (alpha + 2 * w_abs) / beta * (1 + 1e-4) + TRAJ_TOL["rtol"] * w_abs + TRAJ_TOL["atol"]
    w_diff = np.abs(wc - wh)
    check(bool(np.all(w_diff <= allowed)),
          f"CTR weights card vs CPU: max |diff| {float(w_diff.max())}, worst over its bound "
          f"{float((w_diff / allowed).max())} (codes apart per ministep {codes_apart})")
    text = ctr_conf(data, os.path.join(tmp, "pull"), num_data_pass=1).replace(
        "async_sgd {\n", "async_sgd {\n" + PULL_FILTER)
    reset_counts()
    pull = run_cli(text, os.path.join(tmp, "pull.conf"), "cuda")
    sparse_n, dense_n, quant_n = counts()
    n = pull["ministeps"]
    check((sparse_n, dense_n, quant_n) == (0, n, 2 * n),
          f"pull-filter launch counts {(sparse_n, dense_n, quant_n)}, want 0/{n}/{2 * n}")
    return dict(objective_card=oc, objective_cpu=oh, objective_rel_gap=rel_gap,
                codes_apart=codes_apart, decode_bound_sum=e_sum,
                max_abs_weight_diff=float(w_diff.max()),
                weight_diff_over_bound=float((w_diff / allowed).max()),
                pull_ministeps=n, pull_quantize_launches=quant_n, pull_dense_launches=dense_n,
                pull_objective=pull["objective"], pull_step_ms_per_ministep=pull["step_s"] / n * 1e3)


# -- phase 6: LM serving --

# flash_fwd against its plain version, (out rtol, out atol, lse atol); the
# reasons are in tests/test_torch_kernels_cuda.py: float32 sums in another
# order; in bf16 one ulp of the output, plus an absolute term for P rounded
# against the running row max (set from the readings this script prints)
FLASH_TOL = {torch.float32: (0.0, 2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -9, 1e-4)}
SMALL_OUT = 2.0 ** -3  # readings: outputs under this are "small"
# LM agreement: logits within 3x the config's own bf16 noise, measured on
# the JAX reference alone (never on the code under test) by
# tests/torch_lm_bf16_noise.py at seed 0: the largest |logit| gap between
# the reference's bf16 and float32 lm_generate runs of serve_params(0),
# teacher-forced on one 256-byte prompt row and its 32 greedy tokens
REF_BF16_NOISE = 0.02057701349258423
NOISE_MULTIPLE = 3.0
CPU_PROMPT, CPU_STEPS = 256, 32


def close(kernel_out, plain_out, rtol: float, atol: float, what: str) -> dict:
    """|kernel - plain| <= atol + rtol |plain| everywhere. Returns the
    per-element readings: max |diff|; the largest share of the tolerance
    used; the atol that rtol alone would need; the largest |diff| / |plain|
    over outputs of at least SMALL_OUT and the largest |diff| under it."""
    torch.cuda.synchronize()
    k, p = kernel_out.float(), plain_out.float()
    diff, mag = (k - p).abs(), p.abs()
    large = mag >= SMALL_OUT
    r = dict(max_abs=float(diff.max()), tolerance_used=float((diff / (atol + rtol * mag)).max()),
             atol_needed=max(0.0, float((diff - rtol * mag).max())),
             max_rel_large=float((diff[large] / mag[large]).max()) if bool(large.any()) else 0.0,
             max_abs_small=float(diff[~large].max()) if bool((~large).any()) else 0.0)
    print(f"# readings {what}: {r}", flush=True)
    check(r["tolerance_used"] <= 1.0, f"{what}: kernel beyond tolerance ({r}, rtol {rtol}, "
          f"atol {atol})")
    return r


def kept_pairs(sq, sk, causal, q_off, k_off, window) -> int:
    """The (query, key) pairs of one head that attention needs: for each
    query, the keys of [0, Sk) the causal and window masks keep (not the
    masked pairs the kernels' 64 x 64 tiles also compute)."""
    if not causal:
        return sq * sk
    q_pos = np.arange(sq, dtype=np.int64) + q_off
    hi = np.minimum(sk - 1, q_pos - k_off)
    lo = np.maximum(0, q_pos - k_off - window + 1) if window else np.zeros_like(q_pos)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_work(bh, sq, sk, d, group, elt, causal, q_off, k_off, window):
    """(bytes, FLOP) of one forward call: q, k, v read once, out and lse
    written once; 4 D FLOP (two products) per kept pair."""
    nbytes = (2 * bh * sq * d + 2 * (bh // group) * sk * d) * elt + bh * sq * 4
    return nbytes, 4 * d * kept_pairs(sq, sk, causal, q_off, k_off, window) * bh


def flash_case(name: str, gen, bh=64, sq=2048, sk=2048, d=64, dtype=torch.bfloat16,
               q_off=0, k_off=0, window=None, group=1) -> dict:
    """flash_fwd against its plain version on one causal input; CUDA-event
    times of the kernel, the plain version and SDPA (same shapes,
    ``is_causal=True``: a yardstick, no window or offsets)."""
    q = torch.randn(bh, sq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(bh // group, sk, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(bh // group, sk, d, device="cuda", generator=gen).to(dtype)
    args = (q, k, v, q_off, k_off)
    out, lse = fa.launch_kernel(*args, causal=True, window=window, group=group)
    plain_out, plain_lse = fa._flash_plain(*args, True, window, group)
    rtol, atol, lse_tol = FLASH_TOL[dtype]
    readings = close(out, plain_out, rtol, atol, f"flash {name} out")
    err = readings["max_abs"]
    lse_err = close(lse, plain_lse, 0.0, lse_tol, f"flash {name} lse")["max_abs"]
    check(bool(torch.isfinite(out.float()).all()), f"flash {name}: non-finite output")
    again, _ = fa.launch_kernel(*args, causal=True, window=window, group=group)
    torch.cuda.synchronize()
    deterministic = torch.equal(bits(again), bits(out))
    del plain_out, plain_lse, again
    gqa = {"enable_gqa": True} if group > 1 else {}
    nbytes, flops = flash_work(bh, sq, sk, d, group, q.element_size(), True, q_off, k_off, window)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S)
    ms = median_ms(lambda: fa.launch_kernel(*args, causal=True, window=window, group=group))
    return dict(
        case=name, bh=bh, sq=sq, sk=sk, d=d, dtype=str(dtype).split(".")[-1], q_off=q_off,
        k_off=k_off, window=window, group=group, max_abs_err=err, lse_err=lse_err, readings=readings,
        tolerance=dict(rtol=rtol, atol=atol, lse_atol=lse_tol), deterministic=deterministic,
        ms=ms, plain_ms=median_ms(lambda: fa._flash_plain(*args, True, window, group)),
        library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, **gqa)),
        bound_ms=b_ms, bound_by=b_by, flop=flops, bytes=nbytes, tflop_per_s=flops / ms / 1e9,
    )


@contextlib.contextmanager
def plain_attention():
    """Attention through the kernels' plain versions on the card, forward
    and backward: the reference of the agreement checks, never the main
    path."""
    orig = fa._forward, fa._backward
    fa._forward, fa._backward = fa._flash_plain, fa._backward_plain
    try:
        yield
    finally:
        fa._forward, fa._backward = orig


def timed_generate(*args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = transformer.lm_generate(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_tokens(toks, prompt, steps: int, what: str) -> None:
    b, p = prompt.shape
    check(toks.shape == (b, p + steps) and toks.dtype == torch.int64, f"{what}: tokens {toks.shape}")
    check(torch.equal(toks[:, :p], prompt), f"{what}: the prompt is not kept")
    check(int(toks.min()) >= 0 and int(toks.max()) < lm_serve.SERVE_CFG.vocab, f"{what}: a token "
          "outside the vocabulary")


def token_agreement(ref_toks, ref_logits, toks, logits, start: int, tol: float, what: str) -> dict:
    """Tokens equal up to each row's first difference, which must fall at
    a near-tie (the reference's logits rate the two tokens within
    ``tol``); where ``logits`` are given, every logit row computed on
    equal tokens within ``tol`` of the reference's."""
    ref_toks, toks = ref_toks.cpu(), toks.cpu()
    first, gap = [], 0.0
    for r in range(ref_toks.shape[0]):
        diff = (ref_toks[r, start:] != toks[r, start:]).nonzero()
        t = start + int(diff[0]) if len(diff) else ref_toks.shape[1]
        first.append(t)
        if t < ref_toks.shape[1]:
            row = ref_logits[r, t - 1].float().cpu()
            tie = abs(float(row[ref_toks[r, t]] - row[toks[r, t]]))
            check(tie <= tol, f"{what}: row {r} parts at {t} where the logits differ by {tie} > {tol}")
        if logits is not None:
            gap = max(gap, float((ref_logits[r, :t].float().cpu() - logits[r, :t].float().cpu())
                                 .abs().max()))
    check(gap <= tol, f"{what}: logits {gap} apart, tolerance {tol}")
    n = ref_toks.shape[1]
    return dict(first_diff=first, rows_equal=sum(t == n for t in first), max_logit_gap=gap)


def lm_serving(seed: int) -> dict:
    """The serving path at the documented config: greedy and sampled
    ``lm_generate``, the agreement checks, speculative decoding."""
    cfg, dcfg = lm_serve.SERVE_CFG, lm_serve.DRAFT_CFG
    b, p, steps = lm_serve.B, lm_serve.P, lm_serve.STEPS
    params = lm_serve.serve_params(seed, "cuda")
    prompt = lm_serve.make_prompt(seed + 1, device="cuda")
    transformer.lm_generate(params, prompt, cfg, 4)  # warm-up at the timed shapes (cuBLAS, allocator)
    reset_counts()
    first, ttft_s = timed_generate(params, prompt, cfg, 1)
    check(fa.flash_attention.launches == cfg.n_layers, f"prefill: {fa.flash_attention.launches} "
          f"flash launches, want {cfg.n_layers}")
    reset_counts()
    toks, wall_s = timed_generate(params, prompt, cfg, steps)
    flash_n = fa.flash_attention.launches
    check(flash_n == cfg.n_layers and counts() == (0, 0, 0),
          f"greedy: flash launches {flash_n}, others {counts()}; want {cfg.n_layers}, none")
    check_tokens(toks, prompt, steps, "greedy")
    check(torch.equal(toks[:, p], first[:, p]), "greedy: the first token differs from the steps=1 run")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reset_counts()
    sampled, sampled_s = timed_generate(params, prompt, cfg, steps, generator=gen, **lm_serve.SAMPLING)
    check(fa.flash_attention.launches == cfg.n_layers, "sampled: flash launches")
    check_tokens(sampled, prompt, steps, "sampled")

    # the card against the port on the CPU: one row, full width
    tol = NOISE_MULTIPLE * REF_BF16_NOISE
    cpu_params = lm_serve.serve_params(seed, "cpu")
    row = prompt[:1, :CPU_PROMPT].cpu()
    cpu_toks, cpu_logits = transformer.lm_generate(cpu_params, row, cfg, CPU_STEPS, return_logits=True)
    del cpu_params
    card_toks, card_logits = transformer.lm_generate(params, row.cuda(), cfg, CPU_STEPS,
                                                     return_logits=True)
    vs_cpu = token_agreement(cpu_toks, cpu_logits, card_toks, card_logits, CPU_PROMPT, tol,
                             "card vs CPU")
    # the card's kernel against the plain attention on the card, full size
    kern_toks, kern_logits = transformer.lm_generate(params, prompt, cfg, steps, return_logits=True)
    _, tf_kernel = transformer.lm_generate(params, kern_toks, cfg, 0, return_logits=True)
    with plain_attention():
        reset_counts()
        _, tf_plain = transformer.lm_generate(params, kern_toks, cfg, 0, return_logits=True)
        plain_toks, plain_logits = transformer.lm_generate(params, prompt, cfg, steps,
                                                           return_logits=True)
        check(fa.flash_attention.launches == 0, "the plain reference launched the kernel")
    teacher_forced_gap = float((tf_kernel - tf_plain).abs().max())
    check(teacher_forced_gap <= tol, f"teacher-forced logits, kernel vs plain on the card: "
          f"{teacher_forced_gap} apart, tolerance {tol}")
    del tf_kernel, tf_plain
    vs_plain = token_agreement(plain_toks, plain_logits, kern_toks, kern_logits, p, tol,
                               "greedy, kernel vs plain on the card")
    del plain_logits

    dparams = lm_serve.draft_params(seed + 2, "cuda")
    speculative.speculative_generate(params, cfg, dparams, dcfg, prompt, 8,
                                     gamma=lm_serve.GAMMA)  # warm-up at the timed prompt shape
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec_toks, stats = speculative.speculative_generate(params, cfg, dparams, dcfg, prompt, steps,
                                                        gamma=lm_serve.GAMMA, return_stats=True)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    spec_flash = fa.flash_attention.launches
    check(spec_flash == cfg.n_layers + dcfg.n_layers,
          f"speculative: {spec_flash} flash launches, want {cfg.n_layers + dcfg.n_layers}")
    check_tokens(spec_toks, prompt, steps, "speculative")
    vs_greedy = token_agreement(kern_toks, kern_logits, spec_toks, None, p, tol,
                                "speculative vs greedy")
    return dict(
        batch=b, prompt=p, steps=steps, flash_launches=flash_n,
        ttft_ms=ttft_s * 1e3, generate_s=wall_s,
        decode_tokens_per_s=b * (steps - 1) / (wall_s - ttft_s),
        decode_ms_per_step=(wall_s - ttft_s) / (steps - 1) * 1e3,
        sampled_s=sampled_s, sampled_decode_tokens_per_s=b * (steps - 1) / (sampled_s - ttft_s),
        greedy_repeats_timed_run=torch.equal(kern_toks, toks),
        bf16_noise=REF_BF16_NOISE, tolerance=tol, vs_cpu=vs_cpu, teacher_forced_gap=teacher_forced_gap,
        vs_plain=vs_plain, speculative=dict(stats, wall_s=spec_s, flash_launches=spec_flash,
                                            tokens_per_s=b * steps / spec_s, vs_greedy=vs_greedy),
        distinct_tokens_greedy=int(toks[:, p:].unique().numel()),
        distinct_tokens_sampled=int(sampled[:, p:].unique().numel()),
    )


# -- phase 7: LM training --

# flash_bwd_dq / flash_bwd_dkv against their plain version: (rtol, atol as
# a share of the largest |plain| of the gradient). float32: exact products,
# float32 sums in another order, 1e-5 of the gradient's scale (the CUDA
# tests needed 4.2e-7 of it at S <= 333). bf16: one bf16 ulp of each
# output (2^-7 relative, both sides round once) plus 2^-9 of the scale for
# what the two differ by before that rounding: P and dS are rounded to bf16
# from scores summed in another order, so a few of the thousands of bf16
# terms of a gradient sum sit one bf16 ulp apart, and a gradient that
# cancels to near zero keeps that absolute difference (the CUDA tests
# needed up to 2.2e-4 of the scale; this script prints what each case needs)
FLASH_BWD_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -9)}
# LM training agreement: loss and gradients within 3x the config's own
# bf16 noise, measured on the JAX reference alone by
# tests/torch_lm_train_bf16_noise.py at seed 0: the largest |gap| between
# the reference's bf16 and float32 value_and_grad(lm_loss) on the port's
# init_lm(0) weights and one 2048-token row of lm_train.make_tokens(0), by
# parameter kind (the largest over the layers)
REF_TRAIN_BF16_NOISE = {
    "loss": 0.0012006759643554688, "emb": 0.00015932787209749222,
    "ln_f": 2.5488901883363724e-05, "ln1": 1.4778575859963894e-05,
    "ln2": 2.3631611838936806e-05, "wq": 1.2289046935620718e-06,
    "wk": 1.2525051715783775e-06, "wv": 5.2175018936395645e-05,
    "wo": 3.327909507788718e-05, "w1": 3.8081780076026917e-05,
    "w2": 3.597023896872997e-05,
}
TRAIN_AGREE_SEQ = 2048
# the LM CLI on the card against --device cpu: float32, 5 Adam steps of a
# 2-layer model; losses within 1e-4 (sums in another order move a float32
# gradient by ~1e-7 of its scale; Adam's first steps divide by |g| and can
# amplify that for the few gradients near 0, and the loss averages it out)
CLI_SMALL = ["--d-model", "64", "--n-heads", "1", "--n-layers", "2", "--d-ff", "128",
             "--steps", "5", "--report-every", "1", "--seed", "3"]
CLI_LOSS_TOL = 1e-4
CLI_FULL = ["--d-model", "512", "--n-heads", "8", "--n-layers", "8", "--d-ff", "2048", "--bf16",
            "--remat", "--seq-len", "8192", "--batch", "4", "--steps", "30", "--report-every", "5",
            "--prompt", "The parameter server ", "--gen-tokens", "64"]


def flash_bwd_case(name: str, gen, bh=8, sq=8192, sk=8192, d=64, dtype=torch.bfloat16, q_off=0,
                   k_off=0, window=None, group=1, dlse=False) -> dict:
    """The backward kernels through the autograd Function (one flash_fwd,
    one flash_bwd_dq, one flash_bwd_dkv launch) against the plain backward
    on the same out, lse and c; a second backward must give the same
    bits."""
    q = torch.randn(bh, sq, d, device="cuda", generator=gen).to(dtype).requires_grad_()
    k = torch.randn(bh // group, sk, d, device="cuda", generator=gen).to(dtype).requires_grad_()
    v = torch.randn(bh // group, sk, d, device="cuda", generator=gen).to(dtype).requires_grad_()
    do = torch.randn(bh, sq, d, device="cuda", generator=gen).to(dtype)
    dl = torch.randn(bh, sq, device="cuda", generator=gen) if dlse else None
    out, lse = fa._flash(q, k, v, q_off, k_off, True, window, group)
    outs, cots = ((out, lse), (do, dl)) if dlse else ((out,), (do,))
    before = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
    got = torch.autograd.grad(outs, (q, k, v), cots, retain_graph=True)
    again = torch.autograd.grad(outs, (q, k, v), cots)
    check((fa.flash_bwd_dq.launches - before[0], fa.flash_bwd_dkv.launches - before[1]) == (2, 2),
          f"flash bwd {name}: the autograd Function did not launch both kernels")
    torch.cuda.synchronize()
    deterministic = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again))
    check(deterministic, f"flash bwd {name}: two backward passes differ")
    del again
    c = (do.float() * out.float()).sum(-1)
    if dlse:
        c = c - dl
    with torch.no_grad():
        want = fa.flash_attention_bwd_ref(q, k, v, do, lse, c, q_off, k_off, causal=True,
                                          window=window, group=group)
    rtol, share = FLASH_BWD_TOL[dtype]
    readings = {}
    for g, x, y in zip(("dq", "dk", "dv"), got, want):
        scale = max(float(y.float().abs().max()), 1e-30)  # the gradient's largest |plain|
        readings[g] = dict(close(x, y, rtol, share * scale, f"flash bwd {name} {g}"), scale=scale)
    for x in got:
        check(bool(torch.isfinite(x.float()).all()), f"flash bwd {name}: non-finite gradient")
    return dict(case=name, bh=bh, sq=sq, sk=sk, d=d, dtype=str(dtype).split(".")[-1], q_off=q_off,
                k_off=k_off, window=window, group=group, dlse=dlse, readings=readings,
                max_abs_err={g: r["max_abs"] for g, r in readings.items()},
                tolerance=dict(rtol=rtol, atol_share_of_scale=share), deterministic=deterministic)


def flash_bwd_times(gen, bh=32, s=8192, d=64, plain_chunk=8) -> dict:
    """CUDA-event times of flash_bwd_dq and flash_bwd_dkv at the training
    shape (B*H 32, S 8192, D 64, bf16, causal), beside the plain backward
    (dq, dk and dv together, run as B*H / plain_chunk calls: its float32
    score tensors would not fit at once), SDPA's backward (``out.backward``
    after an SDPA forward, ``is_causal``) and each kernel's bound; and
    flash_fwd beside SDPA's forward at the same shape."""
    q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.launch_kernel(q, k, v, causal=True)
    c = (do.float() * out.float()).sum(-1)
    kw = dict(causal=True)
    dq_ms = median_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, c, **kw))
    dkv_ms = median_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, c, **kw))

    def plain():
        with torch.no_grad():
            for i in range(0, bh, plain_chunk):
                sl = slice(i, i + plain_chunk)
                fa.flash_attention_bwd_ref(q[sl], k[sl], v[sl], do[sl], lse[sl], c[sl], causal=True)
    plain_ms = median_ms(plain)
    qs, ks, vs = (t[None].detach().requires_grad_() for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_ms = median_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do[None],
                                                    retain_graph=True))
    del sdpa_out
    with torch.no_grad():
        sdpa_fwd_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True))
    fwd_ms = median_ms(lambda: fa.launch_kernel(q, k, v, causal=True))
    pairs = kept_pairs(s, s, True, 0, 0, None) * bh
    elt = 2
    inputs = 4 * bh * s * d * elt + 2 * bh * s * 4  # q, k, v, do; lse, c
    dq_bound = bound(inputs + bh * s * d * elt, 6 * d * pairs, BF16_FLOP_PER_S)  # S, dP, dQ
    dkv_bound = bound(inputs + 2 * bh * s * d * elt, 8 * d * pairs, BF16_FLOP_PER_S)  # S, dP, dV, dK
    least = bound(inputs + 3 * bh * s * d * elt, 10 * d * pairs, BF16_FLOP_PER_S)  # five products
    return dict(bh=bh, s=s, d=d, pairs=pairs, dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
                sdpa_bwd_ms=sdpa_ms, fwd_ms=fwd_ms, sdpa_fwd_ms=sdpa_fwd_ms, dq_bound_ms=dq_bound[0],
                dq_bound_by=dq_bound[1], dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                both_bound_ms=least[0], dq_tflop_per_s=6 * d * pairs / dq_ms / 1e9,
                dkv_tflop_per_s=8 * d * pairs / dkv_ms / 1e9)


def train_step_full(seed: int, timed: int = 3) -> dict:
    """The main path: make_lm_train_step at the full config, a warm-up
    launch and ``timed`` launches of 8 steps; every flash launch counted."""
    cfg = lm_train.TRAIN_CFG
    params = transformer.init_lm(seed, cfg, "cuda")
    tokens = lm_train.make_tokens(seed, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, losses, secs = lm_train.timed_launches(params, tokens, timed)
    n_steps = (timed + 1) * lm_train.SPL
    fwd_n, dq_n, dkv_n = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                          fa.flash_bwd_dkv.launches)
    want = (2 * cfg.n_layers * n_steps, cfg.n_layers * n_steps, cfg.n_layers * n_steps)
    check((fwd_n, dq_n, dkv_n) == want and counts() == (0, 0, 0),
          f"training launches flash_fwd {fwd_n}, flash_bwd_dq {dq_n}, flash_bwd_dkv {dkv_n}, "
          f"others {counts()}; want {want}, none")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"training losses {losses}")
    return dict(lm_train.summarize(secs), steps=n_steps, flash_fwd_launches=fwd_n,
                flash_bwd_dq_launches=dq_n, flash_bwd_dkv_launches=dkv_n,
                per_step=(fwd_n // n_steps, dq_n // n_steps, dkv_n // n_steps),
                last_launch_losses=losses, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                n_params=lm_train.n_params(), step_flop=lm_train.step_flop())


def train_agreement(seed: int) -> dict:
    """One step's loss and gradients at the full width, batch 1, 2048
    tokens: the kernels against the plain attention on the card, each
    within 3x the JAX reference's bf16-vs-f32 gap for its kind."""
    cfg = lm_train.TRAIN_CFG
    params = transformer.init_lm(seed, cfg, "cuda")
    toks = lm_train.make_tokens(seed, device="cuda")[0, :1, :TRAIN_AGREE_SEQ]

    def loss_and_grads():
        loss, grads = transformer.value_and_grad(lambda p: transformer.lm_loss(p, toks, cfg), params)
        return float(loss), grads

    reset_counts()
    loss_k, g_k = loss_and_grads()
    check(fa.flash_bwd_dq.launches == fa.flash_bwd_dkv.launches == cfg.n_layers,
          "agreement: the kernel step did not launch the backward kernels")
    with plain_attention():
        reset_counts()
        loss_p, g_p = loss_and_grads()
        check(fa.flash_attention.launches == fa.flash_bwd_dq.launches == 0,
              "the plain reference launched a kernel")
    gaps = {"loss": abs(loss_k - loss_p)}
    for name in g_k:
        kind = name.split("/")[-1]
        gaps[kind] = max(gaps.get(kind, 0.0), float((g_k[name] - g_p[name]).abs().max()))
    over = {k: gaps[k] / (NOISE_MULTIPLE * REF_TRAIN_BF16_NOISE[k]) for k in gaps}
    check(max(over.values()) <= 1.0, f"training step, kernels vs plain on the card: gaps {gaps}, "
          f"share of 3x the JAX bf16 noise {over}")
    return dict(loss_kernel=loss_k, loss_plain=loss_p, gaps=gaps, share_of_tolerance=over,
                noise=REF_TRAIN_BF16_NOISE, seq=TRAIN_AGREE_SEQ)


def run_lm_cli(argv) -> "tuple[str, list]":
    """The LM CLI as a user runs it, with ``--log-file``; returns its
    output and the losses of its log lines (6 decimals)."""
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="lm_cli_") as tmp:
        log = os.path.join(tmp, "log.jsonl")
        with contextlib.redirect_stdout(buf):
            rc = lm_main.main(argv + ["--log-file", log])
        with open(log) as f:
            losses = [json.loads(line)["loss"] for line in f]
    check(rc == 0, f"LM CLI {argv} exited {rc}")
    check(losses and all(np.isfinite(losses)), f"LM CLI {argv}: losses {losses}")
    return buf.getvalue(), losses


def lm_cli(seed: int) -> dict:
    """The LM CLI: a small float32 run on the card against the CPU, then
    the full config to a falling loss and a generation."""
    _, card = run_lm_cli(CLI_SMALL + ["--device", "cuda"])
    _, cpu = run_lm_cli(CLI_SMALL + ["--device", "cpu"])
    gap = max(abs(a - b) for a, b in zip(card, cpu))
    check(len(card) == len(cpu) == 5 and gap <= CLI_LOSS_TOL,
          f"LM CLI card {card} vs CPU {cpu}: {gap} apart, tolerance {CLI_LOSS_TOL}")
    cfg = lm_train.TRAIN_CFG
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text, losses = run_lm_cli(CLI_FULL + ["--seed", str(seed)])
    wall = time.perf_counter() - t0
    steps = 30
    want = (2 * cfg.n_layers * steps + cfg.n_layers, cfg.n_layers * steps, cfg.n_layers * steps)
    got = (fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    check(got == want, f"LM CLI launches (flash_fwd, dq, dkv) {got}, want {want} (30 steps of 8 "
          "layers under remat, and the generation's prefill)")
    check(losses[-1] < losses[0], f"LM CLI at the full config: loss did not fall {losses}")
    gen = text.split("--- generation", 1)
    check(len(gen) == 2 and len(gen[1].splitlines()) >= 2, "LM CLI: no generation")
    for line in text.splitlines():
        print(f"# cli | {line}", flush=True)
    return dict(small_card=card, small_cpu=cpu, small_gap=gap, losses=losses, wall_s=wall,
                launches=got, generation=gen[1].split("\n", 1)[1])


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
    print(f"# build: {len(built)} CUDA kernel libraries in {build_s:.1f} s "
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

    quant_rows = [quantize_case(QUANT_P, nb, seed, gen) for nb in (1, 2) for seed in (1, 77, 123457)]
    quant_rows += [quantize_case(QUANT_P - 3, nb, 9, gen) for nb in (1, 2)]
    quant_rows += [quantize_case(QUANT_P, nb, 9, gen, zero=True) for nb in (1, 2)]
    for r in quant_rows:
        print(f"# parity {r['case']}: bit-equal; round trip {r['round_trip']:.3g} <= step "
              f"{r['step']:.3g}; mean error {r['bias_steps']:+.3g} steps", flush=True)
    quant_times = [quantize_times(QUANT_P, nb, gen, 0.05) for nb in (1, 2)]
    for r in quant_times:
        print(f"# time {r['case']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"aminmax (lo/hi) {r['aminmax_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes']} B) [{smi}]", flush=True)

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

    with tempfile.TemporaryDirectory(prefix="ctr_smoke_") as tmp:
        ctr = ctr_path(tmp, args.seed)
        print(f"# CTR conf via CLI (card's own numbers, {smi}): {ctr['ministeps']} ministeps "
              f"({ctr['passes']} passes), launches quantize {ctr['quantize_launches']}, masked dense "
              f"FTRL {ctr['dense_launches']}, sparse {ctr['sparse_launches']}; per ministep: host "
              f"parse+tail filter {ctr['parse_ms_per_ministep']:.3f} ms, prep "
              f"{ctr['prep_ms_per_ministep']:.3f} ms, upload {ctr['upload_ms_per_ministep']:.3f} ms, "
              f"step {ctr['step_ms_per_ministep']:.3f} ms; {ctr['examples_per_s_e2e']:.0f} ex/s end to "
              f"end ({ctr['wall_s']:.1f} s); objective {ctr['objective_first']:.5f} -> "
              f"{ctr['objective_last']:.5f}; model nonzeros {ctr['model_nonzeros']}; a batch touches "
              f"{ctr['touched_frac']:.6f} of the table on average", flush=True)
        agree = ctr_agree_and_pull(tmp, args.seed + 1)
    print(f"# CTR first {len(agree['objective_card'])} ministeps, card vs CPU: "
          f"{['%.5f' % x for x in agree['objective_card']]} vs "
          f"{['%.5f' % x for x in agree['objective_cpu']]} (largest relative gap "
          f"{agree['objective_rel_gap']:.3g}, bar 1e-5; pushed codes apart per ministep "
          f"{agree['codes_apart']}; weights max |diff| {agree['max_abs_weight_diff']:.3g}, "
          f"{agree['weight_diff_over_bound']:.3g} of its bound)", flush=True)
    print(f"# CTR + pull filter: {agree['pull_ministeps']} ministeps, quantize "
          f"{agree['pull_quantize_launches']}, masked dense FTRL {agree['pull_dense_launches']}; "
          f"step {agree['pull_step_ms_per_ministep']:.3f} ms/ministep", flush=True)
    ctr_dense = dense_case(ctr["num_slots"], torch.float32, True, None, gen,
                           frac=ctr["touched_frac"], extra=0.0)
    dense_rows.append(ctr_dense)
    print(f"# parity {ctr_dense['case']} (the CTR step's update): bit-equal; kernel "
          f"{ctr_dense['ms']:.4f} ms, plain {ctr_dense['plain_ms']:.4f} ms, bound "
          f"{ctr_dense['bound_ms']:.4f} ms ({ctr_dense['bound_by']}) [{smi}]", flush=True)

    flash_rows = [
        flash_case("prefill", gen, group=4),  # the serving prefill: 64 query rows, 16 K/V rows
        flash_case("D=128", gen, d=128),
        flash_case("float32", gen, dtype=torch.float32),
        flash_case("window 1024", gen, window=1024, group=4),
        flash_case("offsets, Sq != Sk", gen, sq=1024, q_off=1024, group=4),
        flash_case("ragged Sk tail", gen, sq=1000, sk=2037, q_off=1037, group=4),
    ]
    for r in flash_rows:
        print(f"# parity flash {r['case']} (BH {r['bh']}, Sq {r['sq']}, Sk {r['sk']}, D {r['d']}, "
              f"{r['dtype']}, window {r['window']}, offsets {r['q_off']}/{r['k_off']}, group "
              f"{r['group']}): out max |diff| {r['max_abs_err']:.3g}, lse {r['lse_err']:.3g} within "
              f"{r['tolerance']}; run-to-run bit-identical {r['deterministic']}; kernel "
              f"{r['ms']:.4f} ms ({r['tflop_per_s']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['flop']:.4g} FLOP, {r['bytes']} B) [{smi}]", flush=True)
    lm = lm_serving(args.seed)
    spec = lm["speculative"]
    print(f"# LM serving (card's own numbers, {smi}): B {lm['batch']}, prompt {lm['prompt']}, "
          f"{lm['steps']} steps, bf16, GQA 2, int8 cache: time to first token {lm['ttft_ms']:.1f} ms, "
          f"decode {lm['decode_tokens_per_s']:.0f} tokens/s ({lm['decode_ms_per_step']:.3f} ms/step), "
          f"whole call {lm['generate_s']:.2f} s; sampled (T 0.8, top-k 40, top-p 0.95) "
          f"{lm['sampled_s']:.2f} s; flash launches {lm['flash_launches']} per prefill; distinct "
          f"generated tokens {lm['distinct_tokens_greedy']} greedy, {lm['distinct_tokens_sampled']} "
          f"sampled", flush=True)
    print(f"# LM agreement: tolerance {lm['tolerance']:.4g} = {NOISE_MULTIPLE} x the JAX reference's "
          f"bf16-vs-f32 logit gap {lm['bf16_noise']:.4g} (1 row); card vs CPU {lm['vs_cpu']}; teacher-forced "
          f"logits kernel vs plain on the card {lm['teacher_forced_gap']:.4g}; greedy kernel vs plain "
          f"{lm['vs_plain']}", flush=True)
    print(f"# speculative (gamma {lm_serve.GAMMA}, draft d256 1 layer): {spec['rounds']} rounds, "
          f"accepted {spec['accepted_frac']:.3f}, {spec['wall_s']:.2f} s, {spec['tokens_per_s']:.0f} "
          f"tokens/s, flash launches {spec['flash_launches']} (target + draft prefills); vs greedy "
          f"{spec['vs_greedy']}", flush=True)

    bwd_rows = [
        flash_bwd_case("training shape cut to B*H 8", gen),
        flash_bwd_case("D=128", gen, sq=2048, sk=2048, d=128),
        flash_bwd_case("float32", gen, sq=2048, sk=2048, dtype=torch.float32),
        flash_bwd_case("window 1024", gen, window=1024),
        flash_bwd_case("GQA 4", gen, sq=2048, sk=2048, group=4),
        flash_bwd_case("offsets, Sq != Sk", gen, sq=1024, sk=2048, q_off=1024),
        flash_bwd_case("ragged Sk tail", gen, sq=1000, sk=2037, q_off=1037),
        flash_bwd_case("nonzero dlse", gen, sq=2048, sk=2048, dlse=True),
    ]
    for r in bwd_rows:
        print(f"# parity flash bwd {r['case']} (B*H {r['bh']}, Sq {r['sq']}, Sk {r['sk']}, D {r['d']}, "
              f"{r['dtype']}, window {r['window']}, offsets {r['q_off']}/{r['k_off']}, group "
              f"{r['group']}, dlse {r['dlse']}): max |diff| {r['max_abs_err']} within "
              f"{r['tolerance']}; two backward passes bit-identical {r['deterministic']}", flush=True)
    bwd_t = flash_bwd_times(gen)
    print(f"# time flash bwd (B*H {bwd_t['bh']}, S {bwd_t['s']}, D {bwd_t['d']}, bf16, causal): "
          f"flash_bwd_dq {bwd_t['dq_ms']:.4f} ms ({bwd_t['dq_tflop_per_s']:.1f} TFLOP/s, bound "
          f"{bwd_t['dq_bound_ms']:.4f} ms {bwd_t['dq_bound_by']}), flash_bwd_dkv {bwd_t['dkv_ms']:.4f} "
          f"ms ({bwd_t['dkv_tflop_per_s']:.1f} TFLOP/s, bound {bwd_t['dkv_bound_ms']:.4f} ms "
          f"{bwd_t['dkv_bound_by']}); the gradients' least work {bwd_t['both_bound_ms']:.4f} ms; plain "
          f"backward {bwd_t['plain_ms']:.4f} ms; SDPA backward {bwd_t['sdpa_bwd_ms']:.4f} ms; flash_fwd "
          f"{bwd_t['fwd_ms']:.4f} ms, SDPA forward {bwd_t['sdpa_fwd_ms']:.4f} ms [{smi}]", flush=True)
    train = train_step_full(args.seed)
    print(f"# LM training (card's own numbers, {smi}): d_model 512, 8 layers, seq {lm_train.SEQ}, "
          f"batch {lm_train.BATCH}, bf16, remat, ring_flash, SGD lr {lm_train.LR}, "
          f"{lm_train.SPL} steps a launch: {train['tokens_per_s']:.0f} tokens/s, "
          f"{train['step_ms']:.2f} ms a step, MFU {train['mfu']:.4f} (task_lm's FLOP "
          f"{train['step_flop']:.4g} a step over 989 TFLOP/s); launches a step flash_fwd / dq / dkv "
          f"{train['per_step']}; launch spread {train['launch_spread']:.3f}; peak "
          f"{train['peak_gib']:.2f} GiB; last launch's losses "
          f"{['%.4f' % x for x in train['last_launch_losses']]}", flush=True)
    agree_train = train_agreement(args.seed)
    print(f"# LM training agreement (B 1, S {TRAIN_AGREE_SEQ}), kernels vs plain on the card: loss "
          f"{agree_train['loss_kernel']:.6f} vs {agree_train['loss_plain']:.6f}; gaps "
          f"{agree_train['gaps']}; largest share of 3x the JAX bf16 noise "
          f"{max(agree_train['share_of_tolerance'].values()):.3g}", flush=True)
    cli = lm_cli(args.seed)
    print(f"# LM CLI: 2 layers, d_model 64, float32, 5 Adam steps, card {cli['small_card']} vs CPU "
          f"{cli['small_cpu']} ({cli['small_gap']:.3g} apart, tolerance {CLI_LOSS_TOL}); full config, "
          f"30 Adam steps + 64 generated tokens: losses {cli['losses']}, {cli['wall_s']:.1f} s, "
          f"launches flash_fwd / dq / dkv {cli['launches']} [{smi}]", flush=True)

    main_dense = ctr_dense  # f32 with an explicit mask: what the CTR step runs
    main_sparse = sparse_rows[0]
    main_quant = quant_times[0]  # the conf's 1-byte push
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
             launches=ctr["dense_launches"],
             max_abs_err=max(r["max_abs_err"] for r in dense_rows),
             ms=main_dense["ms"], plain_ms=main_dense["plain_ms"],
             bound_ms=main_dense["bound_ms"], bound_by=main_dense["bound_by"],
             library_ms=None),
        dict(name="quantize_kernel", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/quantize.cu",
             replaces="parameter_server_tpu/ops/quantize.py:68",
             launches=ctr["quantize_launches"],
             max_abs_err=max(r["max_abs_err"] for r in quant_rows),
             ms=main_quant["ms"], plain_ms=main_quant["plain_ms"],
             bound_ms=main_quant["bound_ms"], bound_by=main_quant["bound_by"],
             library_ms=None),
        dict(name="flash_fwd", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/flash_fwd.cu",
             replaces="parameter_server_tpu/ops/flash_attention.py:383",
             launches=lm["flash_launches"],
             max_abs_err=max(r["max_abs_err"] for r in flash_rows),
             tolerance={r["dtype"]: r["tolerance"] for r in flash_rows},
             ms=flash_rows[0]["ms"], plain_ms=flash_rows[0]["plain_ms"],
             bound_ms=flash_rows[0]["bound_ms"], bound_by=flash_rows[0]["bound_by"],
             library_ms=flash_rows[0]["library_ms"]),
        dict(name="flash_bwd_dq", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/flash_bwd.cu",
             replaces="parameter_server_tpu/ops/flash_attention.py:430",
             launches=train["flash_bwd_dq_launches"],
             max_abs_err=max(r["max_abs_err"]["dq"] for r in bwd_rows),
             tolerance={r["dtype"]: r["tolerance"] for r in bwd_rows},
             ms=bwd_t["dq_ms"], plain_ms=bwd_t["plain_ms"], bound_ms=bwd_t["dq_bound_ms"],
             bound_by=bwd_t["dq_bound_by"], library_ms=bwd_t["sdpa_bwd_ms"]),
        dict(name="flash_bwd_dkv", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/flash_bwd.cu",
             replaces="parameter_server_tpu/ops/flash_attention.py:430",
             launches=train["flash_bwd_dkv_launches"],
             max_abs_err=max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]) for r in bwd_rows),
             tolerance={r["dtype"]: r["tolerance"] for r in bwd_rows},
             ms=bwd_t["dkv_ms"], plain_ms=bwd_t["plain_ms"], bound_ms=bwd_t["dkv_bound_ms"],
             bound_by=bwd_t["dkv_bound_by"], library_ms=bwd_t["sdpa_bwd_ms"]),
    ]}
    record = dict(nvidia_smi=smi, device=kind, torch=torch.__version__, cuda=torch.version.cuda,
                  build_seconds=build_s, parity=dense_rows + sparse_rows + quant_rows,
                  quantize_times=quant_times, headline=head, dense_path=dense, bf16_path=bf16,
                  ctr=ctr, ctr_agree_and_pull=agree, kernels=kernel_line["kernels"],
                  run_to_run_deterministic=deterministic, flash=flash_rows, lm_serving=lm,
                  flash_bwd=bwd_rows, flash_bwd_times=bwd_t, lm_train=train,
                  lm_train_agreement=agree_train, lm_cli=cli,
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
