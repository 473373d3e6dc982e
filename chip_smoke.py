#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every kernel.

Run from the root of a checkout, on a machine with a CUDA device and
the CUDA toolkit:

    python3 chip_smoke.py [--seed N] [--timed-launches N]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: the CUDA kernels from ``parameter_server_tpu_torch/kernels/csrc``
   (one library a source, all compiled at once) into ``build/torch_kernels/``,
   and the native host library (``native/psnative.cc``, g++) into
   ``build/psnative/``;
3. kernel parity: each FTRL and quantize kernel against its plain PyTorch version on the
   card, bit for bit (the kernels are built with ``--fmad=false``), at the
   main paths' shapes, with CUDA-event times (``benchmarks/timing.py``:
   cold L2, a spin before the start event) and the HBM-byte bound (for
   the FTRL kernels, counted from the inputs by ``benchmarks/ftrl_bytes.py``,
   beside the floor of the 32-byte sectors the members touch); the
   quantize kernel (range and codes in one launch) also on inputs whose
   min or max is a zero of both signs, with a NaN, constant, and against
   its statistical contract (round trip within one step, unbiased mean),
   timed as the whole ``quantize`` call; the segment-sum kernel at the
   linear step's sums (Xw by row, the gradient by slot, the shard gradient
   by slot) on a headline batch's index vectors and at the CTR step's
   shard gradient by slot (hot keys: runs of thousands): the card's whole
   sum (a stable sort first, or none where the ids come grouped) bit-equal
   to the CPU's and run to run, bounded by the larger of its bytes and its
   serial floor (the longest run of nonzero entries times one dependent
   f32 add, timed on the card; ``benchmarks/segment_bytes.py``);
4. headline path: the port's ``AsyncSGDWorker`` trains the headline
   configuration (2^22-slot FTRL sparse logistic regression, 16384-row
   minibatches of 39 binary features, keys from 2^24, T=8 minibatches per
   launch) through the sparse kernel, then 8 dense ministeps through the
   dense kernel and 8 sparse ministeps with bf16 sqrt_n. The first 2
   ministeps of each configuration are held against the same worker on
   the CPU (and run twice on the card: the two must leave bit-identical
   state), every segment sum of the path launched as the kernel,
   and ``evaluate`` answers a held-out batch. Then the headline worker's
   ``train`` twice on the same batches, a warm-up launch and 8 timed
   launches each, serial and pipelined (feeder, ordered prep pool,
   ``DeviceUploader`` on a side stream): the same state bits and
   objectives, pinned staging buffers, the copies on a stream other than
   the steps'; wall-clock ex/s, prep summed over workers, the copies'
   and the steps' CUDA-event times;
5. CTR path: ``configs/ctr/online_l1lr.conf`` through the port's CLI
   (``parameter_server_tpu_torch.apps.linear.main``) on generated
   SPARSE_BINARY shards, with only its data files and model output
   pointed at a temporary directory: 2^22 slots, 10000-row minibatches,
   the 1-byte FIXING_FLOAT push filter (the quantize kernel and the
   masked dense kernel once per ministep), bounded delay 4, the count-min
   tail filter, the conf's 10 passes. Its first ministeps are held
   against the same CLI run on the CPU (objectives, pushed codes and
   weights); then a few ministeps with a FIXING_FLOAT pull filter added
   (two quantize launches per ministep). Then ``configs/criteo/online_l1lr.conf``
   through the CLI on 4 generated Criteo shards of 50,000 rows
   (``benchmarks/criteo.py``), one pass: the native library parses on the
   reader's byte path, the tail filter runs on its feeder, the masked
   dense kernel and two segment sums a ministep; its objectives equal,
   bit for bit, those of the same CLI run with the Python parser. Each CLI
   run's host stages are timed on the threads they run on (parse, tail
   filter, prep, the wait on the reader) with CUDA events for the upload
   and the step. Then model evaluation on the card: ``configs/ctr/eval_online.conf``
   and ``configs/criteo/eval_batch.conf`` through the CLI on a held-out
   shard of each (30,000 and 50,000 rows, other seeds), scoring the
   models the CTR run and the native-parse Criteo run wrote: one
   segment-sum launch a 16384-row minibatch (2 and 4) and no other
   kernel, the metrics and every margin bit-equal to the same CLI run
   on the CPU, the model's weights the training run's nonzeros; model
   load, parse and key hash on the host clock, the device's work from
   CUDA events, examples/s end to end;
6. LM serving (``benchmarks/lm_serve.py``: the ``doc/SERVING.md`` config,
   d_model 512, 8 heads of dim 64, 2 KV heads, 8 layers, d_ff 2048, bf16,
   int8 KV cache, random weights from the seed): the ``flash_fwd``
   kernel against its plain version at the prefill shape (B*H 64, S 2048,
   D 64, bf16, causal, K/V grouped by 4) and at D 128, float32, window
   1024, offsets with Sq != Sk and a ragged Sk tail, within the stated
   tolerance, with CUDA-event times beside the plain version, SDPA, the
   FLOP bound and the floor of its exponentials on the MUFU unit;
   ``lm_generate`` greedy at batch 8, 2048-token prompts, 256 steps (time
   to first token, decode tokens/s, 8 flash launches a prefill), then
   with the documented sampling options; agreement with
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
import random
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from parameter_server_tpu_torch import kernels  # noqa: E402
from parameter_server_tpu_torch.apps.linear import async_sgd  # noqa: E402
from parameter_server_tpu_torch.apps.linear import main as linear_main  # noqa: E402
from parameter_server_tpu_torch.apps.linear import model_evaluation  # noqa: E402
from parameter_server_tpu_torch.apps.linear.async_sgd import (  # noqa: E402
    AsyncSGDWorker,
    stack_prepped_batches,
)
from parameter_server_tpu_torch import native  # noqa: E402
from parameter_server_tpu_torch.benchmarks.criteo import criteo_conf, write_criteo_shards  # noqa: E402
from parameter_server_tpu_torch.benchmarks.ctr import ctr_conf, eval_conf, write_ctr_shards  # noqa: E402
from parameter_server_tpu_torch.benchmarks.headline import (  # noqa: E402
    ALPHA,
    BETA,
    L1,
    MB,
    SLOTS,
    T,
    conf,
    make_batch,
    sparse_update_inputs,
)
from parameter_server_tpu_torch.apps.lm import main as lm_main  # noqa: E402
from parameter_server_tpu_torch.benchmarks import ftrl_bytes, lm_serve, lm_train  # noqa: E402
from parameter_server_tpu_torch.benchmarks import segment_bytes  # noqa: E402
from parameter_server_tpu_torch.benchmarks.segment_ab import segment_inputs  # noqa: E402
from parameter_server_tpu_torch.benchmarks.timing import median_ms  # noqa: E402
from parameter_server_tpu_torch.filter import fixing_float  # noqa: E402
from parameter_server_tpu_torch.data import text_parser  # noqa: E402
from parameter_server_tpu_torch.learner import sgd as sgd_mod  # noqa: E402
from parameter_server_tpu_torch.learner.sgd import MinibatchReader  # noqa: E402
from parameter_server_tpu_torch.models import speculative, transformer  # noqa: E402
from parameter_server_tpu_torch.ops import flash_attention as fa  # noqa: E402
from parameter_server_tpu_torch.ops import ftrl, ftrl_sparse, quantize  # noqa: E402
from parameter_server_tpu_torch.ops import segment_sum as seg  # noqa: E402

BIG_SLOTS = 1 << 26  # the real-data table of bench.py --real
PIPE_LAUNCHES = 8  # timed launches of T minibatches, serial and pipelined
FTRL_KW = dict(alpha=ALPHA, beta=BETA, l1=L1, l2=0.0)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 << 20
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
FTRL_FLOPS = 22  # arithmetic operations of one FTRL-proximal step
EXP_PER_CLOCK = 16 * 132  # MUFU ex2 a clock: 16 on each SM of an H100 SXM
# card vs CPU: the segment sums add in the same order on both, but the
# step's elementwise math (the loss's exp and log) need not round alike
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def mufu_floor_ms(pairs: int, clock_hz: float) -> float:
    """The least time of the forward's exponentials: one ex2 a kept
    (query, key) pair, EXP_PER_CLOCK a clock (printed beside the tensor
    bound, which bound_ms stays)."""
    return pairs / (EXP_PER_CLOCK * clock_hz) * 1e3


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
    need = ftrl_bytes.dense_counts(keep, n0.element_size(), masked)
    live = need["members"]
    b_ms, b_by = bound(need["bytes"], live * FTRL_FLOPS)
    ms = median_ms(lambda: ftrl.ftrl_update(zk, nk, g, touched, **FTRL_KW, seed=seed))
    plain_ms = median_ms(lambda: ftrl.ftrl_update_ref(zr, nr, g, touched, **FTRL_KW, seed=seed))
    return dict(case=name, p=p, live=live, bytes=need["bytes"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                sector_bytes=need["sector_bytes"],
                sector_floor_ms=ftrl_bytes.ms(need["sector_bytes"]))


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
    changed = torch.zeros(SLOTS, dtype=torch.bool, device="cuda")
    changed[rel[live_mask].long()] = True
    check(torch.equal(zk[~changed], z0[~changed]), f"{name}: kernel wrote a slot it does not own")
    check(int((~ok).sum()) > 0, f"{name}: no sentinel tail in the input")
    need = ftrl_bytes.sparse_counts(rel, ok, g_u, n0.element_size())
    live = need["members"]
    b_ms, b_by = bound(need["bytes"], live * FTRL_FLOPS)
    ms = median_ms(lambda: ftrl_sparse.ftrl_sparse_update(zk, nk, rel, ok, g_u, **FTRL_KW, seed=seed))
    plain_ms = median_ms(lambda: ftrl_sparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g_u, **FTRL_KW, seed=seed))
    return dict(case=name, p=SLOTS, u=u, live=live, bytes=need["bytes"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                sector_bytes=need["sector_bytes"],
                sector_floor_ms=ftrl_bytes.ms(need["sector_bytes"]))


# -- phase 4: the main path --


def reset_counts() -> None:
    ftrl.ftrl_update.launches = 0
    ftrl_sparse.ftrl_sparse_update.launches = 0
    quantize.quantize.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    seg.segment_sum.launches = 0


def counts():
    """(sparse FTRL, dense FTRL, quantize, segment sum) kernel launches
    since the reset."""
    return (ftrl_sparse.ftrl_sparse_update.launches, ftrl.ftrl_update.launches,
            quantize.quantize.launches, seg.segment_sum.launches)


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
    tolerances. The card runs them twice, and the two runs must leave
    bit-identical state (run-to-run determinism: the segment sums add in a
    fixed order)."""
    what = f"{update} {dtype} first 2 ministeps vs CPU"
    workers = [AsyncSGDWorker(conf(update, dtype, 2), device=d) for d in ("cuda", "cuda", "cpu")]
    metrics = []
    for w in workers:
        ms = [run_launch(w, batches[:2])] if update == "sparse" else \
            [run_launch(w, [b]) for b in batches[:2]]
        metrics.append([{k: float(v) for k, v in m.items()} for m in ms])
    deterministic = all(torch.equal(bits(workers[0].state[k]), bits(workers[1].state[k]))
                        for k in workers[0].state)
    check(deterministic, f"{update} {dtype}: two runs on the card left different state")
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
    sparse_n, dense_n, quant_n, seg_n = counts()
    check((sparse_n, dense_n, quant_n, seg_n) == (T * (timed + 1), 0, 0, 2 * T * (timed + 1)),
          f"headline launch counts sparse={sparse_n} dense={dense_n} quantize={quant_n} "
          f"segment_sum={seg_n}, want {T * (timed + 1)}/0/0/{2 * T * (timed + 1)}")
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
        sparse_launches=sparse_n, dense_launches=dense_n, segment_launches=seg_n,
        ministeps_timed=ministeps,
        step_ms_per_ministep=step_s / ministeps * 1e3,
        upload_ms_per_ministep=upload_s / ministeps * 1e3,
        prep_ms_per_ministep=prep_s / ministeps * 1e3,
        examples_per_s_step=ministeps * MB / step_s,
        examples_per_s_e2e=ministeps * MB / (prep_s + upload_s + step_s),
        logloss_per_launch=objectives, evaluate=ev, evaluate_cpu=ev_cpu,
    )


def pipelined_headline(batches) -> dict:
    """The headline worker's ``train`` over the same batches, serial then
    pipelined: a warm-up launch, then PIPE_LAUNCHES timed launches of T
    minibatches. Both must leave the same state bits; the pipelined
    upload must stage through pinned memory and copy on a stream other
    than the step's."""
    runs, states = {}, {}
    for pipelined in (False, True):
        with timed_host() as rec:
            worker = AsyncSGDWorker(conf("sparse"), device="cuda")
            worker.train(batches[:T], pipelined=pipelined)
            warm = host_times(rec)
            for key in ("prep_s", "step_host_s"):
                rec[key] = 0.0
            rec["ministeps"], rec["steps"] = 0, []
            worker.staging.copy_times = []
            reset_counts()
            t0 = time.perf_counter()
            worker.train(batches[T:T * (PIPE_LAUNCHES + 1)], pipelined=pipelined)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = counts()
        n = rec["ministeps"]
        check(n == PIPE_LAUNCHES * T and got == (n, 0, 0, 2 * n),
              f"pipelined={pipelined}: {n} ministeps, launch counts {got}")
        times = host_times(rec)
        states[pipelined] = {k: bits(v).clone() for k, v in worker.state.items()}
        buffers = [b for b in worker.staging.buffers if b is not None]
        check(buffers and all(b.is_pinned() for b in buffers),
              f"pipelined={pipelined}: staging buffers not pinned")
        if pipelined:
            check(times["copy_streams"] == {worker.upload_stream.cuda_stream}
                  and not times["copy_streams"] & times["step_streams"],
                  f"pipelined uploads on streams {times['copy_streams']}, steps on "
                  f"{times['step_streams']}")
        runs["pipelined" if pipelined else "serial"] = dict(
            workers=worker.ingest_workers() if pipelined else 0, ministeps=n,
            examples_per_s=n * MB / wall, wall_s=wall,
            prep_ms_per_ministep=rec["prep_s"] / n * 1e3,
            upload_ms_per_ministep=times["upload_s"] / n * 1e3,
            step_ms_per_ministep=times["step_s"] / n * 1e3,
            warm_step_ms=warm["step_s"] * 1e3 / T,
            objective=list(worker.progress.objective))
    for k in states[False]:
        check(torch.equal(states[False][k], states[True][k]),
              f"pipelined train: {k} differs from the serial train")
    check(runs["serial"]["objective"] == runs["pipelined"]["objective"],
          "pipelined train: objectives differ from the serial train")
    return dict(cpu_count=os.cpu_count(), bit_identical=True, **runs)


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
    got = counts()
    want = (T, 0, 0, 2 * T) if update == "sparse" else (0, T, 0, 2 * T)
    check(got == want, f"{update} {dtype} launch counts {got}, want {want}")
    sparse_n, dense_n = got[:2]
    check(all(np.isfinite(o) for o in objs), f"{update} {dtype}: objective {objs}")
    return dict(sparse_launches=sparse_n, dense_launches=dense_n,
                ms_per_ministep_with_prep=wall / T * 1e3, objective=objs)


# -- phase 3b: the quantize kernel --

QUANT_P = 1 << 22  # the CTR conf's table: the push quantizes the whole shard
# arithmetic of one element: 9 f32 operations (sub, div, mul, convert,
# scale, add, floor, two clamps) and 12 integer ones (the hash)
QUANT_OPS = 21


def quantize_case(p: int, nb: int, seed: int, gen, frac: float = 0.05, zero: bool = False) -> dict:
    """The fused kernel (range and codes in one launch) against the plain
    range and codes, bit for bit, on a pushed-gradient-like input (``frac``
    of the entries nonzero) or on zeros; then the statistical contract of
    the codes."""
    x = torch.zeros(p, device="cuda")
    if not zero:
        x = torch.randn(p, device="cuda", generator=gen)
        x[torch.rand(p, device="cuda", generator=gen) > frac] = 0.0
    name = f"quantize P={p} b={nb} seed={seed}{' zeros' if zero else ''}"
    qk, lo, hi, err = quantize_parity(x, seed, nb, name)
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


def quantize_parity(x, seed: int, nb: int, name: str):
    """One ``quantize.quantize`` call (one launch) against
    ``quantize_range`` and ``quantize_codes`` on the card: ``lo``, ``hi``
    and the codes bit-equal. Returns the kernel's ``(q, lo, hi)`` and the
    codes' max |diff|."""
    before = quantize.quantize.launches
    qk, lo, hi = quantize.quantize(x, seed, nb)
    check(quantize.quantize.launches == before + 1, f"{name}: not one launch")
    lo_p, hi_p = fixing_float.quantize_range(x)
    qp = fixing_float.quantize_codes(x, lo_p, hi_p, seed, nb)
    torch.cuda.synchronize()
    err = float((qk.to(torch.int32) - qp.to(torch.int32)).abs().max())
    check(torch.equal(qk.view(torch.uint8), qp.view(torch.uint8)),
          f"{name}: kernel codes differ from plain (max {err})")
    check(torch.equal(bits(torch.stack([lo, hi])), bits(torch.stack([lo_p, hi_p]))),
          f"{name}: kernel range {float(lo)}, {float(hi)} differs from plain {float(lo_p)}, "
          f"{float(hi_p)}")
    return qk, lo, hi, err


def quantize_range_cases(p: int, nb: int, gen) -> "list[dict]":
    """The range's cases that need care, parity only: a min or a max that
    is a zero of both signs, all zeros of both signs, a NaN, a constant."""
    x = torch.randn(p, device="cuda", generator=gen)
    x[torch.rand(p, device="cuda", generator=gen) > 0.3] = 0.0
    pos = x.abs()
    pos[(pos == 0) & (torch.rand(p, device="cuda", generator=gen) < 0.5)] = -0.0
    zeros = torch.where(torch.rand(p, device="cuda", generator=gen) < 0.5, 0.0, -0.0)
    nan = x.clone()
    nan[p // 3] = float("nan")
    rows = []
    for what, xs in (("min a zero of both signs", pos), ("max a zero of both signs", -pos),
                     ("all zeros of both signs", zeros), ("a NaN", nan),
                     ("constant", torch.full((p,), 5.0, device="cuda"))):
        name = f"quantize P={p} b={nb} {what}"
        _, lo, hi, err = quantize_parity(xs, 17, nb, name)
        rows.append(dict(case=name, p=p, nb=nb, max_abs_err=err,
                         lo_bits=hex(int(lo.view(torch.int32))), hi_bits=hex(int(hi.view(torch.int32)))))
    return rows


def quantize_times(p: int, nb: int, gen, frac: float) -> dict:
    """CUDA-event times of the whole ``quantize.quantize`` call (the fused
    kernel, one launch), of its plain version (``quantize_range`` and
    ``quantize_codes``) and of the plain range alone (``aminmax``, the
    parent's separate range pass); the bound is the whole function's: one
    read of x and the codes written. Where x exceeds the 50 MB L2, the
    kernel's second read of x comes from HBM too: ``two_read_floor_ms``."""
    x = torch.randn(p, device="cuda", generator=gen)
    x[torch.rand(p, device="cuda", generator=gen) > frac] = 0.0
    b_ms, b_by = bound(p * (4 + nb), p * QUANT_OPS)
    return dict(
        case=f"quantize P={p} b={nb}",
        ms=median_ms(lambda: quantize.quantize(x, 5, nb)),
        plain_ms=median_ms(lambda: fixing_float.quantize_codes(x, *fixing_float.quantize_range(x), 5, nb)),
        aminmax_ms=median_ms(lambda: fixing_float.quantize_range(x)),
        bound_ms=b_ms, bound_by=b_by, bytes=p * (4 + nb),
        two_read_floor_ms=p * (8 + nb) / HBM_BYTES_PER_S * 1e3 if 4 * p > L2_BYTES else None,
    )


# -- phase 3c: the segment-sum kernel --


def segment_case(name: str, data, ids, n: int, presorted: bool, ns_per_add: float) -> dict:
    """The whole segment sum on the card (its route as the step takes it)
    against it on the CPU (there ``index_add_`` on the entries as they
    come), bit for bit, and run to run; CUDA-event times of the kernel
    alone on the input it is handed (sorted, or as it comes where the ids
    are grouped), of the plain version there, of the whole function (the
    sort and gather where taken, the kernel) and of one ``index_add_`` on
    the unsorted input (the same function, atomics in no fixed order).
    The bound is the larger of the bytes and the serial floor
    (``benchmarks/segment_bytes.py``)."""
    got = seg.segment_sum(data, ids, n, presorted=presorted)
    want = seg.segment_sum(data.cpu(), ids.cpu(), n)
    err = compare((got,), (want.cuda(),), f"segment_sum {name}")
    again = seg.segment_sum(data, ids, n, presorted=presorted)
    torch.cuda.synchronize()
    check(torch.equal(bits(again), bits(got)), f"segment_sum {name}: two runs differ")
    if presorted:
        kdata, kids, plain = data, ids.to(torch.int32), seg.segment_sum_runs_ref
    else:
        (kdata, kids), plain = seg.sort_by_segment(data, ids, n), seg.segment_sum_sorted_ref
    need = segment_bytes.counts(data, ids, n)
    b_ms, b_by = segment_bytes.bound(need, ns_per_add)
    out = torch.zeros(n, device="cuda")
    return dict(case=name, presorted=presorted, **need, max_abs_err=err,
                ms=median_ms(lambda: seg.launch_kernel(kdata, kids, n)),
                plain_ms=median_ms(lambda: plain(kdata, kids, n)),
                whole_ms=median_ms(lambda: seg.segment_sum(data, ids, n, presorted=presorted)),
                library_ms=median_ms(lambda: out.index_add_(0, ids, data)),
                bytes_ms=segment_bytes.ms(need["bytes"]),
                serial_floor_ms=segment_bytes.serial_floor_ms(need["longest"], ns_per_add),
                bound_ms=b_ms, bound_by=b_by)


# -- phase 5: the CTR conf through the CLI --

CTR_SHARDS, CTR_ROWS = 3, 30_000  # 9 minibatches of 10000 rows a pass
CRITEO_SHARDS, CRITEO_ROWS = 4, 50_000  # 20 minibatches of 10000 rows, one pass
AGREE_ROWS = 70_000  # 7 ministeps: the last 3 pull a learned snapshot (τ = 4)
PULL_FILTER = "  pull_filter {\n    type: FIXING_FLOAT\n    num_bytes: 1\n  }\n"


@contextlib.contextmanager
def timed_host():
    """Times the host side of every worker made inside, on whichever
    thread each stage runs, by wrapping the functions the readers and
    workers call: parse (``ExampleParser``, on the byte path's pool),
    tail filter (on the reader's feeder), prep (on the caller or the
    prep pool), each summed over threads on the host clock; the
    consumer's waits on the reader; and, from CUDA events, each upload's
    copy (on its stream) and each step (on the dispatch thread's stream).
    Yields the record it fills; :func:`host_times` reads it after the run."""
    rec = dict(parse_s=0.0, filter_s=0.0, prep_s=0.0, read_wait_s=0.0, step_host_s=0.0,
               ministeps=0, examples=[], slots=[], workers=[], steps=[])
    lock = threading.Lock()
    orig = dict(parse_text=text_parser.ExampleParser.parse_text,
                parse_lines=text_parser.ExampleParser.parse_lines,
                apply_tail_filter=sgd_mod.apply_tail_filter, read=MinibatchReader.read,
                init=AsyncSGDWorker.__init__, prep=AsyncSGDWorker.prep,
                submit=AsyncSGDWorker._submit_prepped, get_step=AsyncSGDWorker._get_step)

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    rec[key] += time.perf_counter() - t0
        return wrapper

    def init(self, *a, **k):
        orig["init"](self, *a, **k)
        if self.staging is not None:
            self.staging.copy_times = []
        rec["workers"].append(self)

    def submit(self, prepped, with_aux=True):
        rec["examples"].append(prepped.num_examples)
        if isinstance(prepped, async_sgd.HashedBatch):
            rec["slots"].append(prepped.slots)
        rec["ministeps"] += prepped.steps if isinstance(prepped, async_sgd.PreppedSuperBatch) else 1
        return orig["submit"](self, prepped, with_aux)

    def get_step(self, prepped, with_aux):
        step = orig["get_step"](self, prepped, with_aux)
        if self.device.type != "cuda":
            return timed("step_host_s", step)

        def timed_step(*a):
            stream = torch.cuda.current_stream(self.device)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record(stream)
            out = step(*a)
            t1.record(stream)
            rec["steps"].append((stream, t0, t1))
            return out
        return timed_step

    patches = [(text_parser.ExampleParser, "parse_text", timed("parse_s", orig["parse_text"])),
               (text_parser.ExampleParser, "parse_lines", timed("parse_s", orig["parse_lines"])),
               (sgd_mod, "apply_tail_filter", timed("filter_s", orig["apply_tail_filter"])),
               (MinibatchReader, "read", timed("read_wait_s", orig["read"])),
               (AsyncSGDWorker, "__init__", init), (AsyncSGDWorker, "prep", timed("prep_s", orig["prep"])),
               (AsyncSGDWorker, "_submit_prepped", submit), (AsyncSGDWorker, "_get_step", get_step)]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for (owner, name, _), key in zip(patches, orig):
            setattr(owner, name, orig[key])


def host_times(rec: dict) -> dict:
    """The record's upload and step seconds from their events (after a
    synchronize), and the streams they ran on."""
    torch.cuda.synchronize()
    copies = [c for w in rec["workers"] if w.staging is not None for c in w.staging.copy_times]
    return dict(upload_s=sum(a.elapsed_time(b) for _, a, b in copies) / 1e3,
                step_s=sum(a.elapsed_time(b) for _, a, b in rec["steps"]) / 1e3 + rec["step_host_s"],
                copy_streams={s.cuda_stream for s, _, _ in copies},
                step_streams={s.cuda_stream for s, _, _ in rec["steps"]})


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


def run_cli(conf_text: str, path: str, device: str, seed: int = 0) -> dict:
    """The port's CLI on a conf, as a user runs it (Python's ``random``,
    which orders the workload pool's files, seeded first); returns the
    timed record."""
    with open(path, "w") as f:
        f.write(conf_text)
    random.seed(seed)
    with timed_host() as rec:
        t0 = time.perf_counter()
        rc = linear_main.main([path], device=device)
        rec["wall_s"] = time.perf_counter() - t0
    check(rc == 0, f"CLI on {path} ({device}) exited {rc}")
    if device == "cuda":
        rec.update(host_times(rec))
    else:
        rec.update(upload_s=0.0, step_s=rec["step_host_s"])
    (w,) = rec.pop("workers")
    rec["worker"] = w
    rec["objective"] = [o / e for o, e in zip(w.progress.objective, rec["examples"])]
    check(len(rec["objective"]) == rec["ministeps"] > 0 and all(np.isfinite(rec["objective"])),
          f"CLI on {path} ({device}): objective {rec['objective']}")
    return rec


def per_ministep(rec: dict) -> dict:
    """The host-side stages' ms a ministep (parse, filter and prep summed
    over threads; the consumer's waits on the reader; upload and step
    from CUDA events)."""
    n = rec["ministeps"]
    return {f"{k}_ms_per_ministep": rec[f"{k}_s"] / n * 1e3
            for k in ("parse", "filter", "prep", "read_wait", "upload", "step")}


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
    sparse_n, dense_n, quant_n, seg_n = counts()
    n = rec["ministeps"]
    check((sparse_n, dense_n, quant_n, seg_n) == (0, n, n, 2 * n),
          f"CTR launch counts sparse={sparse_n} dense={dense_n} quantize={quant_n} "
          f"segment_sum={seg_n}, want 0/{n}/{n}/{2 * n}")
    worker = rec.pop("worker")
    check(worker.update_path == "cuda_dense" and worker.sgd.max_delay == 4,
          f"CTR worker: {worker.update_path}, max_delay {worker.sgd.max_delay}")
    touched = touched_share(rec, worker.num_slots)
    examples = sum(rec.pop("examples"))
    return dict(
        passes=worker.sgd.num_data_pass, ministeps=n, examples=examples, sparse_launches=sparse_n,
        dense_launches=dense_n, quantize_launches=quant_n, segment_launches=seg_n,
        touched_frac=touched, **per_ministep(rec),
        wall_s=rec["wall_s"], examples_per_s_e2e=examples / rec["wall_s"],
        objective_first=rec["objective"][0], objective_last=rec["objective"][-1],
        model_nonzeros=model_nonzeros(model + "_S0"), num_slots=worker.num_slots,
    )


@contextlib.contextmanager
def python_parsing():
    """Every ``ExampleParser`` made inside takes the Python parser
    (``use_native=False``)."""
    init = text_parser.ExampleParser.__init__

    def python_init(self, format_="libsvm", use_native=True):
        init(self, format_, use_native=False)

    text_parser.ExampleParser.__init__ = python_init
    try:
        yield
    finally:
        text_parser.ExampleParser.__init__ = init


def criteo_path(tmp: str, seed: int) -> dict:
    """The Criteo conf through the CLI on the card, on generated Criteo
    text parsed by the native library on the reader's feeder (one pass,
    every ministep counted), then the same CLI run with the Python
    parser: the same batches, so the same objectives, bit for bit."""
    data = os.path.join(tmp, "criteo")
    write_criteo_shards(data, CRITEO_SHARDS, CRITEO_ROWS, seed)
    runs = {}
    for parser in ("native", "python"):
        model = os.path.join(tmp, f"criteo_{parser}")
        text = criteo_conf(os.path.join(data, "part.*"), model)
        reset_counts()
        with python_parsing() if parser == "python" else contextlib.nullcontext():
            runs[parser] = rec = run_cli(text, os.path.join(tmp, f"criteo_{parser}.conf"), "cuda", seed)
        got, n = counts(), rec["ministeps"]
        check(got == (0, n, 0, 2 * n), f"Criteo ({parser} parse) launch counts {got}, want 0/{n}/0/{2 * n}")
    rec, worker = runs["native"], runs["native"]["worker"]
    check(worker.update_path == "cuda_dense" and worker.sgd.max_delay == 4
          and worker.num_slots == 1 << 22 and worker.sgd.tail_feature_freq == 4,
          f"Criteo worker: {worker.update_path}, max_delay {worker.sgd.max_delay}, "
          f"slots {worker.num_slots}")
    check(rec["objective"] == runs["python"]["objective"],
          f"Criteo objectives, native parse {rec['objective']} vs Python parse "
          f"{runs['python']['objective']}")
    n = rec["ministeps"]
    examples = sum(rec["examples"])
    return dict(shards=CRITEO_SHARDS, rows=CRITEO_ROWS, ministeps=n, examples=examples,
                dense_launches=n, segment_launches=2 * n, **per_ministep(rec),
                wall_s=rec["wall_s"], examples_per_s_e2e=examples / rec["wall_s"],
                python_parse=dict(**per_ministep(runs["python"]), wall_s=runs["python"]["wall_s"]),
                objective=rec["objective"], model_nonzeros=model_nonzeros(
                    os.path.join(tmp, "criteo_native_S0")))


def ctr_agree_and_pull(tmp: str, seed: int) -> dict:
    """The CTR conf's first 7 ministeps (one pass over a 70000-row shard)
    on the card and on the CPU; both draw the same quantization noise.
    Then the same with a FIXING_FLOAT pull filter on the card: two
    quantize launches per ministep.

    What must agree, and how closely:
    - the first τ ministeps pull the zero table, so every row gradient
      is ±1/2 and each pushed shard gradient an exact sum: their codes
      and ranges are bit-equal;
    - later pushes are computed from weights whose last bits may differ
      (the step's elementwise math need not round alike on the two
      devices), so a code may differ by one, and the range by its last
      bits (a code counts where the pushed entry is nonzero: the wire
      zeroes the rest);
    - objectives within 1e-5 relative (the unfiltered agreement's bar):
      with τ = 4 all 7 forward passes read the zero table or the
      snapshot after the 4 exact ministeps, so only their last bits
      differ;
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
    sparse_n, dense_n, quant_n, seg_n = counts()
    n = pull["ministeps"]
    check((sparse_n, dense_n, quant_n, seg_n) == (0, n, 2 * n, 2 * n),
          f"pull-filter launch counts {(sparse_n, dense_n, quant_n, seg_n)}, want "
          f"0/{n}/{2 * n}/{2 * n}")
    return dict(objective_card=oc, objective_cpu=oh, objective_rel_gap=rel_gap,
                codes_apart=codes_apart, decode_bound_sum=e_sum,
                max_abs_weight_diff=float(w_diff.max()),
                weight_diff_over_bound=float((w_diff / allowed).max()),
                pull_ministeps=n, pull_quantize_launches=quant_n, pull_dense_launches=dense_n,
                pull_objective=pull["objective"], pull_step_ms_per_ministep=pull["step_s"] / n * 1e3)


# -- phase 5b: model evaluation on the card --

# dataset -> (eval conf, held-out shard writer, rows, the seed offset of its data)
EVAL_SETS = {
    "ctr": ("configs/ctr/eval_online.conf", write_ctr_shards, CTR_ROWS, 3),
    "criteo": ("configs/criteo/eval_batch.conf", write_criteo_shards, CRITEO_ROWS, 4),
}


@contextlib.contextmanager
def timed_eval():
    """Times the stages of every ``ModelEvaluation`` made inside: the
    model load (``load_model``, host clock), its install on the device
    (host clock, to a synchronize), the parse (``ExampleParser``, summed
    over the byte path's threads), the key hash (``lookup``, host) and
    each minibatch's device work (``xw``: the index and value uploads, the
    lookup, the multiply and the segment sum) from CUDA events on the
    current stream. Yields the record it fills."""
    ME = model_evaluation.ModelEvaluation
    rec = dict(load_s=0.0, install_s=0.0, parse_s=0.0, hash_s=0.0, events=[], minibatches=0,
               evals=[])
    lock = threading.Lock()
    orig = dict(parse_text=text_parser.ExampleParser.parse_text,
                parse_lines=text_parser.ExampleParser.parse_lines, init=ME.__init__,
                load_model=ME.load_model, install=ME.install, lookup=ME.lookup, xw=ME.xw)

    def timed(key, fn, sync=False):
        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(self, *a, **k)
                if sync and self.device.type == "cuda":
                    torch.cuda.synchronize()
                return out
            finally:
                with lock:
                    rec[key] += time.perf_counter() - t0
        return wrapper

    def init(self, *a, **k):
        orig["init"](self, *a, **k)
        rec["evals"].append(self)

    def xw(self, batch, lookup):
        rec["minibatches"] += 1
        if self.device.type != "cuda":
            return orig["xw"](self, batch, lookup)
        stream = torch.cuda.current_stream(self.device)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record(stream)
        out = orig["xw"](self, batch, lookup)
        t1.record(stream)
        rec["events"].append((t0, t1))
        return out

    patches = [(text_parser.ExampleParser, "parse_text", timed("parse_s", orig["parse_text"])),
               (text_parser.ExampleParser, "parse_lines", timed("parse_s", orig["parse_lines"])),
               (ME, "__init__", init), (ME, "load_model", timed("load_s", orig["load_model"])),
               (ME, "install", timed("install_s", orig["install"], sync=True)),
               (ME, "lookup", timed("hash_s", orig["lookup"])), (ME, "xw", xw)]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for (owner, name, _), key in zip(patches, orig):
            setattr(owner, name, orig[key])


def run_eval(conf_text: str, path: str, device: str) -> dict:
    """The port's CLI on an eval conf; returns its timed record with the
    evaluation's metrics, margins and model, and the line it printed."""
    with open(path, "w") as f:
        f.write(conf_text)
    out = io.StringIO()
    with timed_eval() as rec, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = linear_main.main([path], device=device)
        rec["wall_s"] = time.perf_counter() - t0
    check(rc == 0, f"CLI on {path} ({device}) exited {rc}")
    (ev,) = rec.pop("evals")
    if device == "cuda":
        torch.cuda.synchronize()
    rec["device_s"] = sum(a.elapsed_time(b) for a, b in rec.pop("events")) / 1e3
    table = getattr(ev, "table", None)
    rec.update(line=out.getvalue().strip().splitlines()[-1], metrics=dict(ev.metrics),
               margins=ev.margins, num_weights=ev.num_weights, hashed_slots=ev.hashed_slots,
               table_nonzeros=None if table is None else int(torch.count_nonzero(table)))
    return rec


def eval_path(tmp: str, seed: int, model_globs: dict, nonzeros: dict) -> dict:
    """Each eval conf through the CLI on the card, on a held-out shard of
    its dataset (another seed) and the model its training run on the card
    wrote; then the same CLI run on the CPU. The metrics and every margin
    bit-equal; one segment-sum launch a minibatch and no other kernel; the
    model's weights the training run's nonzeros."""
    out = {}
    for name, (conf, write, rows, offset) in EVAL_SETS.items():
        data = os.path.join(tmp, f"{name}_test")
        write(data, 1, rows, seed + offset)
        text = eval_conf(os.path.join(ROOT, conf), os.path.join(data, "part.*"), model_globs[name])
        runs = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            runs[dev] = run_eval(text, os.path.join(tmp, f"eval_{name}_{dev}.conf"), dev)
            runs[dev]["launches"] = counts()
        card, cpu = runs["cuda"], runs["cpu"]
        mb = -(-rows // model_evaluation.MINIBATCH)
        check(card["minibatches"] == mb and card["launches"] == (0, 0, 0, mb),
              f"eval {name}: {card['minibatches']} minibatches, launches (sparse, dense, quantize, "
              f"segment_sum) {card['launches']}, want {mb} and (0, 0, 0, {mb})")
        check(card["metrics"] == cpu["metrics"] and card["line"] == cpu["line"],
              f"eval {name}: card {card['metrics']} vs CPU {cpu['metrics']}")
        check(np.array_equal(card["margins"].view(np.int32), cpu["margins"].view(np.int32)),
              f"eval {name}: margins differ from the CPU's")
        check(card["num_weights"] == card["table_nonzeros"] == nonzeros[name] > 0,
              f"eval {name}: {card['num_weights']} weights, {card['table_nonzeros']} nonzero in the "
              f"table, the training run wrote {nonzeros[name]}")
        m = card["metrics"]
        check(m["num_examples"] == rows and all(np.isfinite(list(m.values()))) and m["auc"] > 0.5,
              f"eval {name}: metrics {m}")
        out[name] = dict(
            conf=conf, rows=rows, minibatches=mb, segment_launches=card["launches"][3],
            weights=card["num_weights"], hashed_slots=card["hashed_slots"], metrics=m,
            line=card["line"], load_ms=card["load_s"] * 1e3, install_ms=card["install_s"] * 1e3,
            parse_ms=card["parse_s"] * 1e3, hash_ms=card["hash_s"] * 1e3,
            device_ms=card["device_s"] * 1e3, wall_s=card["wall_s"],
            examples_per_s_e2e=rows / card["wall_s"], cpu_wall_s=cpu["wall_s"])
    return out


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
        pairs=flops // (4 * d),
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
    check(flash_n == cfg.n_layers and counts() == (0, 0, 0, 0),
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
    fwd_bound = bound(*flash_work(bh, s, s, d, 1, elt, True, 0, 0, None), BF16_FLOP_PER_S)
    return dict(bh=bh, s=s, d=d, pairs=pairs, dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
                sdpa_bwd_ms=sdpa_ms, fwd_ms=fwd_ms, sdpa_fwd_ms=sdpa_fwd_ms, dq_bound_ms=dq_bound[0],
                dq_bound_by=dq_bound[1], dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                both_bound_ms=least[0], fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                dq_tflop_per_s=6 * d * pairs / dq_ms / 1e9,
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
    check((fwd_n, dq_n, dkv_n) == want and counts() == (0, 0, 0, 0),
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
    clock_hz = float(nvidia_smi_line("clocks.max.sm").split()[0]) * 1e6
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)  # nvidia-smi: name, power.limit
    print(f"# device: {kind}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t_build = time.perf_counter()
    built = kernels.build_all()
    build_s = time.perf_counter() - t_build
    print(f"# build: {len(built)} CUDA kernel libraries in {build_s:.1f} s "
          f"-> {kernels.BUILD_DIR}", flush=True)
    t_native = time.perf_counter()
    native.library()
    native_s = time.perf_counter() - t_native
    print(f"# build: the native host library in {native_s:.1f} s -> {native.library_path()}",
          flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    dense_rows = [
        dense_case(SLOTS, torch.float32, True, None, gen),
        dense_case(SLOTS, torch.float32, False, None, gen),
        dense_case(SLOTS, torch.bfloat16, False, 7, gen),
        dense_case(SLOTS, torch.bfloat16, True, 7, gen),
        dense_case(BIG_SLOTS, torch.float32, False, None, gen),
    ]
    rel, ok, g_u = sparse_update_inputs(args.seed + 1_000_000, gen)
    sparse_rows = [
        sparse_case(torch.float32, None, rel, ok, g_u, gen),
        sparse_case(torch.bfloat16, 7, rel, ok, g_u, gen),
    ]
    for r in dense_rows + sparse_rows:
        print(f"# parity {r['case']}: bit-equal; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes']} B, live {r['live']}), "
              f"sector floor {r['sector_floor_ms']:.4f} ms ({r['sector_bytes']} B) [{smi}]", flush=True)

    quant_rows = [quantize_case(QUANT_P, nb, seed, gen) for nb in (1, 2) for seed in (1, 77, 123457)]
    quant_rows += [quantize_case(QUANT_P - 3, nb, 9, gen) for nb in (1, 2)]
    quant_rows += [quantize_case(QUANT_P, nb, 9, gen, zero=True) for nb in (1, 2)]
    for r in quant_rows:
        print(f"# parity {r['case']}: lo, hi and codes bit-equal, one launch; round trip "
              f"{r['round_trip']:.3g} <= step {r['step']:.3g}; mean error {r['bias_steps']:+.3g} steps",
              flush=True)
    range_rows = [row for p, nb in ((QUANT_P, 1), (QUANT_P - 3, 2), (100, 1))
                  for row in quantize_range_cases(p, nb, gen)]
    for r in range_rows:
        print(f"# parity {r['case']}: lo {r['lo_bits']}, hi {r['hi_bits']} and codes bit-equal to "
              "quantize_range + quantize_codes", flush=True)
    quant_rows += range_rows
    quant_times = [quantize_times(QUANT_P, nb, gen, 0.05) for nb in (1, 2)]
    quant_times.append(quantize_times(BIG_SLOTS, 1, gen, 0.05))
    for r in quant_times:
        two = r["two_read_floor_ms"]
        print(f"# time {r['case']}: quantize (range + codes, one launch) {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, its range alone (aminmax) {r['aminmax_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes']} B)"
              + (f", floor of two reads of x {two:.4f} ms (x past the L2)" if two else "")
              + f" [{smi}]", flush=True)
    lat = segment_bytes.add_latency()
    print(f"# dependent f32 add (one thread, {lat['adds']} adds): {lat['cycles_per_add']:.3f} cycles, "
          f"{lat['ns_per_add']:.4f} ns an add, SM clock {lat['sm_clock_mhz']:.0f} MHz [{smi}]",
          flush=True)
    seg_rows = [segment_case(*case, lat["ns_per_add"])
                for case in segment_inputs(args.seed + 2_000_000, gen)]
    for r in seg_rows:
        route = "no sort (ids grouped)" if r["presorted"] else "stable sort first"
        print(f"# parity segment_sum {r['case']} ({r['entries']} entries, {r['live']} nonzero, "
              f"{r['segments']} segments, longest run {r['longest']}; {route}): card bit-equal to "
              f"the CPU, run to run; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, whole "
              f"sum {r['whole_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, bytes "
              f"{r['bytes_ms']:.4f} ms, serial floor {r['serial_floor_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]", flush=True)

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
    batches += [make_batch(args.seed + i) for i in range(len(batches), T * (PIPE_LAUNCHES + 1))]
    pipe = pipelined_headline(batches)
    ser, par = pipe["serial"], pipe["pipelined"]
    print(f"# pipelined headline (card's own numbers, {smi}): host os.cpu_count() {pipe['cpu_count']}, "
          f"{par['workers']} prep workers; {PIPE_LAUNCHES} launches of T={T} after a warm-up; serial / "
          f"pipelined: {ser['examples_per_s']:.0f} / {par['examples_per_s']:.0f} ex/s wall-clock; prep "
          f"{ser['prep_ms_per_ministep']:.3f} / {par['prep_ms_per_ministep']:.3f} ms a ministep "
          f"(summed over workers); upload {ser['upload_ms_per_ministep']:.3f} / "
          f"{par['upload_ms_per_ministep']:.3f} ms (events on the copy's stream: the step's / a side "
          f"stream, pinned); device step {ser['step_ms_per_ministep']:.3f} / "
          f"{par['step_ms_per_ministep']:.3f} ms; z and sqrt_n bits identical", flush=True)
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
              f"parse {ctr['parse_ms_per_ministep']:.3f} ms, tail filter "
              f"{ctr['filter_ms_per_ministep']:.3f} ms (both on the reader's threads), the "
              f"consumer's wait on the reader {ctr['read_wait_ms_per_ministep']:.3f} ms, prep "
              f"{ctr['prep_ms_per_ministep']:.3f} ms, upload {ctr['upload_ms_per_ministep']:.3f} ms, "
              f"step {ctr['step_ms_per_ministep']:.3f} ms; {ctr['examples_per_s_e2e']:.0f} ex/s end to "
              f"end ({ctr['wall_s']:.1f} s); objective {ctr['objective_first']:.5f} -> "
              f"{ctr['objective_last']:.5f}; model nonzeros {ctr['model_nonzeros']}; a batch touches "
              f"{ctr['touched_frac']:.6f} of the table on average", flush=True)
        agree = ctr_agree_and_pull(tmp, args.seed + 1)
        crit = criteo_path(tmp, args.seed + 2)
        evals = eval_path(tmp, args.seed, dict(
            ctr=os.path.join(tmp, "model", "ctr_online.*"),
            criteo=os.path.join(tmp, "criteo_native_S*")),
            dict(ctr=ctr["model_nonzeros"], criteo=crit["model_nonzeros"]))
    py = crit["python_parse"]
    print(f"# Criteo conf via CLI (card's own numbers, {smi}): {crit['shards']} x {crit['rows']} rows, "
          f"one pass, {crit['ministeps']} ministeps, launches masked dense FTRL {crit['dense_launches']}, "
          f"segment_sum {crit['segment_launches']}; per ministep: native parse "
          f"{crit['parse_ms_per_ministep']:.3f} ms (on the byte path's 2 threads), tail filter "
          f"{crit['filter_ms_per_ministep']:.3f} ms (feeder), the consumer's wait on the reader "
          f"{crit['read_wait_ms_per_ministep']:.3f} ms, prep {crit['prep_ms_per_ministep']:.3f} ms, "
          f"upload {crit['upload_ms_per_ministep']:.3f} ms, step {crit['step_ms_per_ministep']:.3f} ms; "
          f"{crit['examples_per_s_e2e']:.0f} ex/s end to end ({crit['wall_s']:.2f} s); model nonzeros "
          f"{crit['model_nonzeros']}; the Python parser's run: parse {py['parse_ms_per_ministep']:.3f} "
          f"ms a ministep, {py['wall_s']:.2f} s, objectives bit-equal to the native run's", flush=True)
    for name, ev in evals.items():
        print(f"# eval {name} ({ev['conf']} via CLI, card's own numbers, {smi}): {ev['rows']} held-out "
              f"rows, {ev['minibatches']} minibatches, model {ev['weights']} weights (hashed, "
              f"{ev['hashed_slots']} slots); model load {ev['load_ms']:.1f} ms (host), install "
              f"{ev['install_ms']:.1f} ms, parse {ev['parse_ms']:.1f} ms (host, summed over threads), "
              f"key hash {ev['hash_ms']:.1f} ms (host), device {ev['device_ms']:.3f} ms (CUDA events: "
              f"uploads, lookup, multiply, segment sum); {ev['examples_per_s_e2e']:.0f} ex/s end to end "
              f"({ev['wall_s']:.2f} s; the CPU run {ev['cpu_wall_s']:.2f} s); segment_sum launches "
              f"{ev['segment_launches']}, no FTRL or quantize; metrics and every margin bit-equal to "
              f"the CPU run: {ev['line']}", flush=True)
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
          f"{ctr_dense['bound_ms']:.4f} ms ({ctr_dense['bound_by']}, {ctr_dense['bytes']} B, live "
          f"{ctr_dense['live']}), sector floor {ctr_dense['sector_floor_ms']:.4f} ms "
          f"({ctr_dense['sector_bytes']} B) [{smi}]", flush=True)

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
              f"{r['flop']:.4g} FLOP, {r['bytes']} B), MUFU floor "
              f"{mufu_floor_ms(r['pairs'], clock_hz):.4f} ms at {clock_hz / 1e6:.0f} MHz [{smi}]",
              flush=True)
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
          f"{bwd_t['fwd_ms']:.4f} ms (bound {bwd_t['fwd_bound_ms']:.4f} ms {bwd_t['fwd_bound_by']}, "
          f"MUFU floor {mufu_floor_ms(bwd_t['pairs'], clock_hz):.4f} ms at {clock_hz / 1e6:.0f} MHz), "
          f"SDPA forward {bwd_t['sdpa_fwd_ms']:.4f} ms [{smi}]", flush=True)
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
    main_quant = quant_times[0]  # the conf's 1-byte push: the whole quantize call
    main_seg = seg_rows[3]  # the CTR step's shard gradient by slot: the costliest on the paths
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
        dict(name="segment_sum", route="cuda", case=main_seg["case"],
             source="parameter_server_tpu_torch/kernels/csrc/segment_sum.cu",
             replaces="parameter_server_tpu/apps/linear/async_sgd.py:1556",
             launches=ctr["segment_launches"],
             eval_launches={name: ev["segment_launches"] for name, ev in evals.items()},
             max_abs_err=max(r["max_abs_err"] for r in seg_rows),
             ms=main_seg["ms"], plain_ms=main_seg["plain_ms"],
             bound_ms=main_seg["bound_ms"], bound_by=main_seg["bound_by"],
             library_ms=main_seg["library_ms"]),
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
                  quantize_times=quant_times, add_latency=lat, segment_sum=seg_rows, headline=head,
                  pipelined_headline=pipe, dense_path=dense, bf16_path=bf16, criteo=crit,
                  native_build_seconds=native_s,
                  ctr=ctr, ctr_agree_and_pull=agree, model_evaluation=evals,
                  kernels=kernel_line["kernels"],
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
