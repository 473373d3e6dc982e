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
   sparse kernel also under a KKT keep mask with holes among the real
   slots, at 2^22 and, bf16 √n, at 2^30 slots; the
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
   and the steps' CUDA-event times. Then the rest of the step: the
   headline under the KKT filter (escape 1/64: the first ministep's counts
   and state bits equal to the CPU's, then 16 ministeps with the counts
   and state within the stated card-vs-CPU tolerances; escape 1
   bit-identical to no filter; the drop set engaging and revisiting, the
   feedback's copy to the host timed), on the compact exact wire with a
   64 MB upload cache (pipelined, state bit-identical to the raw wire;
   bytes copied a example, hit share, host encode ms, ex/s) and on the
   bits wire (dense 2^22, ELL lanes 39: a decoded batch equal to the raw
   one, state bit-identical to the hashed path at T 8, τ 0; then timed at
   τ 4, T 8);
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
   CUDA events, examples/s end to end. Then the CTR conf with adaptive τ
   (one pass over 300,000 rows, card and CPU: the same τ trajectory), the
   Criteo data on the stream wire through the CLI (state bit-identical to
   the hashed path, a decoded batch equal to the raw one), and
   ``configs/criteo/online_l1lr_bigtable.conf`` through the CLI at its
   2^30 slots on the Criteo data (the sparse update, bf16 √n, T 8, τ 4:
   ex/s, the stages' ms, peak device memory, a falling loss, the model
   written). Then the darlin app (block coordinate descent) through the
   CLI: ``configs/criteo/batch_l1lr.conf`` unchanged (λ 4, α 0.9, τ 2, up
   to 50 passes, 39 blocks, one a slot) on 4 generated shards of 250,000
   rows, and ``eval_batch.conf`` on its model over 100,000 held-out rows;
   ``configs/ctr/batch_l1lr.conf`` (τ 0, feature block ratio 4: one group
   of ~31 keys a row in ~123 blocks) on the CTR cell's data and its
   ``eval_batch.conf``; the Criteo conf cut
   to 50,000 rows twice on the card (w, the dual and every progress line
   bit-identical) and once on the CPU (each pass's objective within
   ``DARLIN_OBJ_RTOL``, the counts within ``DARLIN_COUNT_TOL`` of the
   columns); three segment-sum launches a block step and no other
   kernel; the wall split (load + localize, upload, passes), block
   steps/s, each block step's CUDA-event time, the slowest and the median
   block's sums as segment-sum parity rows (card bit-equal to the CPU,
   beside ``index_add_`` and the serial floor), peak device memory;
6. LM serving (``benchmarks/lm_serve.py``: the ``doc/SERVING.md`` config,
   d_model 512, 8 heads of dim 64, 2 KV heads, 8 layers, d_ff 2048, bf16,
   int8 KV cache, random weights from the seed): the ``flash_fwd``
   kernel against its plain version at the prefill shape (B*H 64, S 2048,
   D 64, bf16, causal, K/V grouped by 4) and at D 128, float32, window
   1024, offsets with Sq != Sk and a ragged Sk tail; in float32 (3xTF32 on
   the tensor cores) also with K/V grouped by 4, at D 128 with a window
   of 1024, with offsets and a ragged Sk tail, at D 32 and at S 8192;
   each within the stated tolerance and bit-identical run to run, with
   CUDA-event times beside the plain version, SDPA, the bound and the
   floor of its exponentials on the MUFU unit;
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
   nonzero lse gradient, and the float32 route (3xTF32 on the tensor
   cores) at GQA 4, D 128 with window 1024, offsets with a ragged Sk tail
   and a lse gradient, D 16 at the LM CLI's default shape, D 32 with a
   window and GQA 2, and S 8192 (where the sums' drift shows), within the
   stated tolerances and bit-identical run to run (``# flash_bwd float32``:
   each gradient's largest share of its tolerance); their CUDA-event times
   at B*H 32 beside the plain backward, SDPA's backward and the FLOP
   bound, and ``flash_fwd`` beside SDPA's forward at that shape, and the
   same in float32 (the LM CLI's default dtype) at B*H 64 x S 2048, at the
   CLI's default B*H 32 x S 256 x D 16 and at D 128, beside the three TF32
   passes at mma.sync's rate measured alone; ``make_lm_train_step`` at
   the full config (a warm-up launch and 3 timed launches of 8 steps:
   tokens/s, step ms, MFU; flash launches asserted: 16 forward, 8 of each
   backward kernel a step); one step's loss and gradients against the same
   step with the plain attention on the card (batch 1, 2048 tokens),
   within 3x the JAX reference's own bf16-vs-f32 gaps
   (``tests/torch_lm_train_bf16_noise.py``); the LM CLI
   (``parameter_server_tpu_torch.apps.lm.main``) at 2 layers, d_model 64,
   float32 (its launches of the float32 backward pair counted), on the
   card against ``--device cpu``, then at the full config for 30
   Adam steps to a falling loss and a 64-token generation;
7b. the rest of the LM family: (a) MoE serving, the phase 6 config with
   every second layer a mixture of 8 experts (capacity factor 8, so
   training drops no token): greedy ``lm_generate`` at batch 8, 2048-token
   prompts, 64 steps (time to first token, decode tokens/s, 8 flash
   launches a prefill), the prefill's logits against the training
   forward ``lm_forward`` within phase 6's tolerance; (b) ``lm_beam_search``
   at the phase 6 config, width 4, batch 8, 2048-token prompts, 128 steps
   (``script/onchip.py``'s shape; sequences x steps/s from the 128-step
   call less the 1-step call), each prompt's best score against teacher
   forcing through ``lm_forward``, width 1 against greedy ``lm_generate``;
   (c) three turns through ``lm_generate_continue`` (a 2048-token prompt
   and 64 steps, a 64-token turn and 64 steps, an ingest-only 64-token
   turn then 64 steps), each later turn's tokens against single-shot
   ``lm_generate`` over the whole history (``token_agreement``); on each
   of these paths ``flash_fwd`` is held to its plain version on the
   inputs the path gave its first launch; (d) the LM CLI: the full
   config with ``--moe-every 2`` for 10 Adam steps and ``--beam 4`` (a
   falling loss, launches of ``flash_fwd`` and the backward pair counted
   and the pair held to the plain backward on the path's own first
   inputs, step ms, peak memory), the small config under ``--optimizer
   adafactor`` (at d_model 128, where it factors every matrix) and
   ``lion`` on the card against ``--device cpu``, and a 5-step
   ``--ckpt-dir`` run resumed to 10 steps (the batch stream starting over,
   as in the JAX CLI), card against ``--device cpu``;
8. the serving plane (``parameter_server_tpu_torch.apps.serve.main``):
   ``flash_fwd`` against its plain version at the serve CLI's decode-lane
   prefill (float32, heads of 16) and at a batcher join; A. the serve CLI
   through ``main()`` at 2^22 slots, every other flag at its default, with
   ``--replica full --train-while-serving --decode --batch-slots 8``, then
   ``--replica hot`` and ``--replica off``: each record printed, no load
   point with an error, the 3x point shedding under admission, every
   admitted request completed, launches counted from zero a run; B. the
   same seed and key pool on the card and on the CPU: the table after the
   warm push, and the values and predict scores of the pool's 512
   requests in each replica mode (and the replica held on the card),
   bit-equal; C. the device-resident replica at 2^30 slots (4 GiB) under
   a 2 GiB host budget: host mode refused, device mode serving through a
   stream of in-place pushes with no degraded answer; refresh and gather
   times, peak device memory; D. the continuous batcher at
   ``decode_batching_ab``'s full shapes (target d_model 512, 8 heads, 2
   layers; draft d_model 128; gamma 2; prompts of 8; 40-48 new tokens),
   slots 1, 4, 8 and 16, 6 sessions a slot joining as slots free: every
   session's tokens equal to its solo ``speculative_generate`` run,
   batched against sequential tokens/s;
8b. telemetry on the card (``parameter_server_tpu_torch/telemetry``): (a)
   phase 5's CTR conf cut to one pass through the linear CLI, with
   ``--report-interval 1 --profile DIR`` and without: the same model bits,
   the ``torch.profiler`` capture's ``ftrl_dense`` / ``quantize`` /
   ``segment_sum`` kernel records equal to the launch counters, the
   dashboard printed; (b) the serve CLI at phase A's defaults with
   ``--replica full --decode --batch-slots 8 --expose-port 0``, scraped
   from a thread (``/metrics``, ``/healthz``, ``/debug/snapshot``; the
   scrape's host time): ``ps_serve_requests_total`` equal to the CLI's own
   record, ``ps_device_hbm_bytes_in_use`` equal to
   ``torch.cuda.memory_stats()`` read beside it; (c) the LM CLI's
   2-layer float32 default for 5 steps with ``--profile`` and without:
   bit-equal losses, the capture's ``flash_fwd`` / ``flash_bwd_dq`` /
   ``flash_bwd_dkv`` records equal to the counters; (d) the device
   inventory sampling every 8th call over the pipelined headline: the
   roofline gauges present, every ``ps_device_roofline_frac`` at most
   1.05, no new signature after warm-up, no dispatch fallback; (e) the
   pipelined headline with telemetry on and off, three pairs in turns,
   each beside a run with telemetry on and the key heat never noted, the
   medians printed;
9. a ``{"kernels": [...]}`` line: each kernel's launches, parity and times;
10. the last line: ``{"ok": true, "device": {...}}``.

Launch counters are zeroed before each path and read after it. Every
time printed is measured on the card in this run. Full records go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
from parameter_server_tpu_torch.apps.linear import async_sgd, darlin  # noqa: E402
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
from parameter_server_tpu_torch.apps.lm import optim  # noqa: E402
from parameter_server_tpu_torch.apps.serve import main as serve_main  # noqa: E402
from parameter_server_tpu_torch.benchmarks import flash_ab, ftrl_bytes, lm_serve, lm_train  # noqa: E402
from parameter_server_tpu_torch.benchmarks import segment_bytes  # noqa: E402
from parameter_server_tpu_torch.benchmarks.segment_ab import segment_inputs  # noqa: E402
from parameter_server_tpu_torch.benchmarks.timing import median_ms  # noqa: E402
from parameter_server_tpu_torch.filter import fixing_float  # noqa: E402
from parameter_server_tpu_torch.data import text_parser  # noqa: E402
from parameter_server_tpu_torch.learner import sgd as sgd_mod  # noqa: E402
from parameter_server_tpu_torch.learner import consistency, wire  # noqa: E402
from parameter_server_tpu_torch.learner.sgd import MinibatchReader  # noqa: E402
from parameter_server_tpu_torch.models import speculative, transformer  # noqa: E402
from parameter_server_tpu_torch.ops import flash_attention as fa  # noqa: E402
from parameter_server_tpu_torch.ops import ftrl, ftrl_sparse, quantize  # noqa: E402
from parameter_server_tpu_torch.ops import segment_sum as seg  # noqa: E402
from parameter_server_tpu_torch.ops.kv_ops import localize  # noqa: E402
from parameter_server_tpu_torch.serving import (  # noqa: E402
    BatcherConfig,
    ContinuousBatcher,
    DecodeRequest,
    PredictRequest,
    PullRequest,
    ReadReplica,
    ServeConfig,
    ServeFrontend,
)

BIG_SLOTS = 1 << 26  # the real-data table of bench.py --real
PIPE_LAUNCHES = 8  # timed launches of T minibatches, serial and pipelined
FTRL_KW = dict(alpha=ALPHA, beta=BETA, l1=L1, l2=0.0)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 << 20
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# The float32 flash kernels' least time counts their FLOP at a third of
# the TF32 rate: an f32-accurate product on the tensor cores takes three
# TF32 passes (3xTF32: hi.hi + hi.lo + lo.hi, within ~2^-22 of the f32
# product; one pass keeps ~2^-11 and misses FLASH_TOL by ~50x), which is
# less time than one pass on the CUDA cores at F32_FLOP_PER_S. Each f32 row
# also prints its time at F32_FLOP_PER_S, for readings taken against that.
F32_TC_FLOP_PER_S = TF32_FLOP_PER_S / 3
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


_clock_hz = None


def max_sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), read once."""
    global _clock_hz
    if _clock_hz is None:
        _clock_hz = float(nvidia_smi_line("clocks.max.sm").split()[0]) * 1e6
    return _clock_hz


def mufu_floor_ms(pairs: int, clock_hz: float) -> float:
    """The least time of the forward's exponentials: one ex2 a kept
    (query, key) pair, EXP_PER_CLOCK a clock (printed beside the tensor
    bound, which bound_ms stays)."""
    return pairs / (EXP_PER_CLOCK * clock_hz) * 1e3


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(nbytes: float, flops: float, pairs: int, dtype) -> "tuple[float, str]":
    """A flash kernel's least time (ms, "bytes" or "operations"): bf16, its
    FLOP on the tensor cores or its bytes; float32, its FLOP in 3xTF32, its
    bytes or its exponentials (one a kept pair, mufu_floor_ms), whichever
    takes longest."""
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, BF16_FLOP_PER_S)
    b = bound(nbytes, flops, F32_TC_FLOP_PER_S)
    mufu = mufu_floor_ms(pairs, max_sm_clock_hz())
    return (mufu, "operations") if mufu > b[0] else b


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


def sparse_case(n_dtype, seed, rel, ok, g_u, gen, p: int = SLOTS, label: str = "") -> dict:
    """``label``: " interior keep" where ``ok`` is the KKT step's
    ``ok & keep``, with holes among the real slots."""
    u = rel.numel()
    z0 = torch.randn(p, device="cuda", generator=gen)
    n0 = (torch.rand(p, device="cuda", generator=gen) * 2).to(n_dtype)
    zk, nk, zr, nr = z0.clone(), n0.clone(), z0.clone(), n0.clone()
    ftrl_sparse.ftrl_sparse_update(zk, nk, rel, ok, g_u, **FTRL_KW, seed=seed)
    ftrl_sparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g_u, **FTRL_KW, seed=seed)
    name = f"sparse P=2^{p.bit_length() - 1} U={u} {'bf16 seed' if n_dtype == torch.bfloat16 else 'f32'}{label}"
    err = compare((zk, nk), (zr, nr), name)
    live_mask = ok & (g_u != 0)
    changed = torch.zeros(p, dtype=torch.bool, device="cuda")
    changed[rel[live_mask].long()] = True
    check(torch.equal(zk[~changed], z0[~changed]) and torch.equal(bits(nk[~changed]), bits(n0[~changed])),
          f"{name}: kernel wrote a slot it does not own")
    check(int((~ok).sum()) > 0, f"{name}: no sentinel tail in the input")
    need = ftrl_bytes.sparse_counts(rel, ok, g_u, n0.element_size())
    live = need["members"]
    b_ms, b_by = bound(need["bytes"], live * FTRL_FLOPS)
    ms = median_ms(lambda: ftrl_sparse.ftrl_sparse_update(zk, nk, rel, ok, g_u, **FTRL_KW, seed=seed))
    plain_ms = median_ms(lambda: ftrl_sparse.ftrl_sparse_rows_ref(zr, nr, rel, ok, g_u, **FTRL_KW, seed=seed))
    del z0, n0, zr, nr
    return dict(case=name, p=p, u=u, live=live, bytes=need["bytes"], max_abs_err=err, ms=ms,
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


# -- phase 4b: the rest of the async-SGD step (KKT, the encoded wires) --

KKT_LAUNCHES = 2  # launches of T headline minibatches, card and CPU
KKT_ESCAPE = 1.0 / 64.0
# card vs CPU: suppressed slots apart, as a share of the candidates
# (the loss's exp rounds differently on the two devices; the decision
# |z + g| <= λ1 flips for a slot that close to the threshold)
KKT_COUNT_TOL = 1e-4
# ... and the table's slots beyond TRAJ_TOL (those whose decision flipped)
KKT_STATE_TOL = 1e-3


def interior_keep(u: int, ok, gen):
    """A KKT-shaped keep vector: holes anywhere among the real slots."""
    return ok & (torch.rand(u, device=ok.device, generator=gen) < 0.6)


def bigtable_update_inputs(seed: int, gen):
    """The sparse update's inputs on a headline batch hashed into the
    bigtable conf's 2^30 slots (``sparse_update_inputs`` at that size)."""
    from parameter_server_tpu_torch.parameter.parameter import KeyDirectory

    p = 1 << 30
    batch = make_batch(seed)
    nnz_pad = max(4096, -(-int(batch.nnz * 1.25) // 4096) * 4096)
    uniq = -(-min(nnz_pad, p) // 1024) * 1024
    pb = async_sgd.prep_batch_shared(batch, KeyDirectory(p), 1, MB, nnz_pad, uniq, p)
    rel, ok = localize(torch.as_tensor(pb.uslots[0]).cuda(), p)
    g_u = torch.randn(uniq, device="cuda", generator=gen) * torch.as_tensor(pb.umask[0]).cuda()
    return rel, ok, g_u


def kkt_conf(**sgd):
    c = conf("sparse")
    for k, v in sgd.items():
        setattr(c.async_sgd, k, v)
    return c


def kkt_path(batches) -> dict:
    """The headline sparse path (2^22 slots, 16384 x 39 keys, T = 8, λ1 = 1)
    under the KKT filter:
    - escape 1/64, the first ministep on the card and on the CPU: the
      counts and the state bits equal (the weights are zero, so every
      row gradient is exactly ±1/2);
    - escape 1/64, ``KKT_LAUNCHES`` launches on the card and on the CPU:
      the candidates equal; the suppressed counts within
      ``KKT_COUNT_TOL`` of the candidates (the loss's exp need not round
      alike on the two devices, ``agree_with_cpu``, so a slot whose
      ``|z + g|`` lies within those last bits of λ1 may fall on either
      side); the state within the card-vs-CPU tolerance except at most
      ``KKT_STATE_TOL`` of the table's slots (a flipped slot took or
      skipped a whole update); the objectives within 1e-5 relative;
    - escape 1.0: bit-identical to the unfiltered run on the card;
    - ``kkt_drop_after`` 2, ``ingest_workers=1``, per-minibatch launches
      (the feedback needs them): the drop set engages and revisits."""
    group = batches[:KKT_LAUNCHES * T]
    first = {}
    for dev in ("cuda", "cpu"):
        w = AsyncSGDWorker(kkt_conf(kkt_filter=True, kkt_escape=KKT_ESCAPE, steps_per_launch=1),
                           device=dev)
        w.collect(w.process_minibatch(group[0]))
        first[dev] = w
    fc, fh = (first[d]._consistency.tracker.summary() for d in ("cuda", "cpu"))
    check(fc == fh and 0 < fc["suppressed"] < fc["candidates"],
          f"KKT first ministep: card {fc} vs CPU {fh}")
    for k in first["cuda"].state:
        check(torch.equal(bits(first["cuda"].state[k].cpu()), bits(first["cpu"].state[k])),
              f"KKT first ministep: {k} differs from the CPU's")
    del first
    runs = {}
    for dev in ("cuda", "cpu"):
        w = AsyncSGDWorker(kkt_conf(kkt_filter=True, kkt_escape=KKT_ESCAPE), device=dev)
        reset_counts()
        t0 = time.perf_counter()
        w.train(iter(group), pipelined=False)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = dict(worker=w, wall=time.perf_counter() - t0, launches=counts(),
                         summary=w._consistency.tracker.summary())
    card, cpu = runs["cuda"], runs["cpu"]
    n = len(group)
    check(card["launches"] == (n, 0, 0, 2 * n), f"KKT launch counts {card['launches']}, want {n}/0/0/{2 * n}")
    s, sh = card["summary"], cpu["summary"]
    gap = abs(s["suppressed"] - sh["suppressed"])
    check(s["candidates"] == sh["candidates"] and s["reconciled"]
          and gap <= KKT_COUNT_TOL * s["candidates"],
          f"KKT counts card {s} vs CPU {sh}")
    check(0 < s["suppressed"] < s["candidates"], f"KKT: nothing or everything suppressed {s}")
    # a slot whose decision flipped took (or skipped) a whole update:
    # beyond TRAJ_TOL there, within it everywhere else
    apart = torch.zeros(SLOTS, dtype=torch.bool)
    for k, x in card["worker"].state.items():
        x, y = x.cpu().float(), cpu["worker"].state[k].float()
        apart |= ~torch.isclose(x, y, **TRAJ_TOL)
    n_apart = int(apart.sum())
    check(n_apart <= KKT_STATE_TOL * SLOTS, f"KKT escape 1/64 vs CPU: {n_apart} slots apart")
    oc = [float(x) for x in card["worker"].progress.objective]
    oh = [float(x) for x in cpu["worker"].progress.objective]
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(oc, oh)), f"KKT objectives card {oc} vs CPU {oh}")
    bits_equal = n_apart == 0 and all(
        torch.equal(bits(card["worker"].state[k].cpu()), bits(cpu["worker"].state[k]))
        for k in card["worker"].state)
    states = {}
    for name, sgd in (("off", {}), ("escape 1", dict(kkt_filter=True, kkt_escape=1.0))):
        w = AsyncSGDWorker(kkt_conf(**sgd), device="cuda")
        w.train(iter(group), pipelined=False)
        states[name] = {k: bits(v).clone() for k, v in w.state.items()}
    for k in states["off"]:
        check(torch.equal(states["off"][k], states["escape 1"][k]), f"KKT escape 1: {k} differs from no filter")
    drop = AsyncSGDWorker(kkt_conf(kkt_filter=True, kkt_margin=1e9, kkt_escape=0.0, kkt_drop_after=2,
                                   kkt_revisit_every=5, ingest_workers=1, steps_per_launch=1),
                          device="cuda")
    reset_counts()
    feedback = dict(copy_s=0.0, copies=0, track_s=0.0)
    host, note = consistency._host, consistency.SignificanceTracker._note_feedback

    def timed_host_copy(x):  # the collect has waited for the step
        t = time.perf_counter()
        out = host(x)
        feedback["copy_s"] += time.perf_counter() - t
        feedback["copies"] += 1
        return out

    def timed_note(self, *a):
        t = time.perf_counter()
        note(self, *a)
        feedback["track_s"] += time.perf_counter() - t

    consistency._host, consistency.SignificanceTracker._note_feedback = timed_host_copy, timed_note
    try:
        t0 = time.perf_counter()
        drop.train(iter([group[0]] * 10), pipelined=False)
        torch.cuda.synchronize()
        drop_wall = time.perf_counter() - t0
    finally:
        consistency._host, consistency.SignificanceTracker._note_feedback = host, note
    d = drop._consistency.tracker.summary()
    check(feedback["copies"] == 20, f"KKT feedback: {feedback['copies']} copies to the host, want 20")
    check(d["dropped_slots"] > 0 and d["filtered_batches"] > 0 and d["revisit_batches"] == 2,
          f"KKT drop set: {d}")
    return dict(escape=KKT_ESCAPE, ministeps=n, counts=s, cpu_counts=sh, suppressed_gap=gap,
                slots_apart=n_apart,
                first_ministep_counts=fc, state_bits_equal_cpu=bits_equal,
                card_wall_s=card["wall"], cpu_wall_s=cpu["wall"], sparse_launches=card["launches"][0],
                escape1_bit_identical=True, drop=d, drop_launches=counts()[0],
                drop_ms_per_ministep=drop_wall / 10 * 1e3,
                feedback_copy_ms_per_ministep=feedback["copy_s"] / 10 * 1e3,
                feedback_track_ms_per_ministep=feedback["track_s"] / 10 * 1e3)


@contextlib.contextmanager
def timed_encode():
    """Host seconds of ``encode_exact`` summed over the prep threads."""
    rec = dict(encode_s=0.0)
    lock = threading.Lock()
    orig = wire.encode_exact

    def enc(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            with lock:
                rec["encode_s"] += time.perf_counter() - t0

    wire.encode_exact = enc
    try:
        yield rec
    finally:
        wire.encode_exact = orig


ENC_LAUNCHES = 4  # launches of T a pass; two passes, the second repeating the first


def encoded_path(batches) -> dict:
    """The headline on the compact exact wire with the upload cache, as
    ``bench.py`` runs it (``wire_encode="exact"``, ``wire_cache_mb`` 64,
    the pipelined train), against the raw wire on the same batches: two
    passes over ``ENC_LAUNCHES`` launches of T, the second repeating the
    first (the cache's hits). The state must be bit-identical; the bytes
    copied to the card a example, the cache's hit share, the host encode
    a ministep and the wall-clock ex/s are measured. One decoded batch
    equals the raw one on the card, dtype for dtype."""
    seq = batches[:ENC_LAUNCHES * T] * 2
    out, states = {}, {}
    for name, sgd in (("raw", {}), ("exact", dict(wire_encode="exact", wire_cache_mb=64))):
        with timed_encode() as rec:
            w = AsyncSGDWorker(kkt_conf(**sgd), device="cuda")
            w.train(iter(batches[:T]), pipelined=True)  # warm-up
            w.staging.copied_bytes = 0
            reset_counts()
            t0 = time.perf_counter()
            w.train(iter(seq), pipelined=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = len(seq)
        check(counts() == (n, 0, 0, 2 * n), f"encoded {name}: launch counts {counts()}")
        states[name] = {k: bits(v).clone() for k, v in w.state.items()}
        cache = w.upload_cache
        out[name] = dict(ministeps=n, examples_per_s=n * MB / wall, wall_s=wall,
                         uploaded_bytes_per_example=w.staging.copied_bytes / (n * MB),
                         encode_ms_per_ministep=rec["encode_s"] / (n + T) * 1e3,
                         cache_hit_share=None if cache is None else cache.hit_share,
                         cache_saved_bytes=None if cache is None else cache.saved_bytes)
    for k in states["raw"]:
        check(torch.equal(states["raw"][k], states["exact"][k]), f"encoded wire: {k} differs from the raw wire")
    check(out["exact"]["cache_hit_share"] > 0, "encoded wire: the cache never hit")
    w = AsyncSGDWorker(kkt_conf(), device="cuda")
    raw = w.prep(batches[0], device_put=False)
    enc = wire.encode_exact(raw, w.num_slots)
    check(enc is not None, "encode_exact refused a headline batch")
    dev_enc = w.upload(enc)
    dec = wire.decode_exact_shard(dev_enc, w.num_slots, 0)
    for name, got in zip(async_sgd._EXACT, dec):
        want = torch.as_tensor(getattr(raw, name)[0])
        check(got.dtype == want.dtype and torch.equal(got.cpu(), want), f"decoded {name} differs from the raw wire")
    out["raw_batch_bytes_per_example"] = wire.batch_nbytes(raw) / MB
    out["encoded_batch_bytes_per_example"] = wire.batch_nbytes(enc) / MB
    return out


def bits_paths(batches) -> dict:
    """The headline on ``wire: bits`` (dense 2^22, ``ell_lanes`` 39): each
    decoded batch equals the raw one; T = 8, τ = 0 leaves the state
    bit-identical to the hashed per-entry path (per minibatch); then the
    timed run at ``bench.py --wire-encode ''``'s settings (τ 4, T 8)."""
    w = AsyncSGDWorker(kkt_conf(update="dense", ell_lanes=39, wire="bits"), device="cuda")
    host = w.prep(batches[0], device_put=False)
    check(isinstance(host, async_sgd.ELLBitsBatch), f"bits wire: prep gave {type(host).__name__}")
    y, mask, rows, slots, _, _ = async_sgd._bits_decode(w.num_slots, 39)(w.upload(host), 0)
    b = batches[0]
    check(torch.equal(slots.cpu(), torch.as_tensor(w.directory.slots(b.indices)))
          and torch.equal(y.cpu(), torch.as_tensor(b.y)) and float(mask.sum()) == MB
          and slots.dtype == torch.int32 and y.dtype == mask.dtype == torch.float32,
          "bits wire: a decoded batch differs from the raw one")
    group = batches[:2 * T]
    states = {}
    for name, sgd in (("hashed", dict(update="dense", steps_per_launch=1)),
                      ("bits", dict(update="dense", ell_lanes=39, wire="bits"))):
        w = AsyncSGDWorker(kkt_conf(**sgd), device="cuda")
        reset_counts()
        w.train(iter(group), pipelined=False)
        n = len(group)
        check(counts() == (0, n, 0, 2 * n), f"{name}: launch counts {counts()}, want 0/{n}/0/{2 * n}")
        states[name] = {k: bits(v).clone() for k, v in w.state.items()}
    for k in states["hashed"]:
        check(torch.equal(states["hashed"][k], states["bits"][k]), f"bits wire: {k} differs from the hashed path")
    w = AsyncSGDWorker(kkt_conf(update="dense", ell_lanes=39, wire="bits", max_delay=4), device="cuda")
    w.train(iter(batches[:T]), pipelined=True)
    w.staging.copied_bytes = 0
    reset_counts()
    timed = batches[T:T * (PIPE_LAUNCHES + 1)]
    t0 = time.perf_counter()
    w.train(iter(timed), pipelined=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(timed)
    got = counts()
    check(got == (0, n, 0, 2 * n), f"bits timed: launch counts {got}")
    return dict(ministeps=n, dense_launches=got[1], segment_launches=got[3],
                examples_per_s=n * MB / wall, wall_s=wall,
                uploaded_bytes_per_example=w.staging.copied_bytes / (n * MB),
                objective=list(w.progress.objective)[-3:])


def stream_path(tmp: str, seed: int) -> dict:
    """The Criteo conf's generated data (``CRITEO_SHARDS`` x
    ``CRITEO_ROWS`` rows) through the CLI on ``ell_lanes: 39, wire:
    "stream"`` (tail filter off, so the rows stay 39 wide; τ 0, T 8) and on
    the hashed per-entry path: the state bit-identical; the decoded batch
    equal to the raw one; the launches counted."""
    data = os.path.join(tmp, "criteo")
    if not os.path.isdir(data):
        write_criteo_shards(data, CRITEO_SHARDS, CRITEO_ROWS, seed)
    runs = {}
    for name, extra in (("stream", dict(ell_lanes=39, wire='"stream"')), ("hashed", {})):
        text = criteo_conf(os.path.join(data, "part.*"), os.path.join(tmp, f"stream_{name}"),
                           tail_feature_freq=0, max_delay=0, steps_per_launch=8, **extra)
        reset_counts()
        runs[name] = rec = run_cli(text, os.path.join(tmp, f"stream_{name}.conf"), "cuda", seed)
        n = rec["ministeps"]
        check(counts() == (0, n, 0, 2 * n), f"stream {name}: launch counts {counts()}")
        rec["launches"] = counts()
    sw, hw = runs["stream"]["worker"], runs["hashed"]["worker"]
    check(sw._stream_statics is not None, "stream: no lane split won on the Criteo data")
    for k in sw.state:
        check(torch.equal(bits(sw.state[k]), bits(hw.state[k])), f"stream wire: {k} differs from the hashed path")
    reader = MinibatchReader(files=[os.path.join(data, "part-001")], minibatch_size=10_000,
                             data_format="criteo")
    with reader:
        b = next(iter(reader))
    host = sw.prep(b, device_put=False)
    check(isinstance(host, wire.EncodedEllStreamBatch), f"stream: prep gave {type(host).__name__}")
    y, mask, slots = wire.decode_stream_shard(sw.upload(host), 0)
    check(torch.equal(slots[:b.n].cpu().reshape(-1), torch.as_tensor(sw.directory.slots(b.indices)))
          and torch.equal(y[:b.n].cpu(), torch.as_tensor(b.y)) and slots.dtype == torch.int32,
          "stream wire: a decoded batch differs from the raw one")
    st = sw._stream_statics
    rec = runs["stream"]
    n = rec["ministeps"]
    return dict(ministeps=n, dense_launches=n, segment_launches=2 * n, dict_lanes=len(st.dict_lanes),
                code_bits=st.code_bits, raw_bits=st.raw_bits,
                stream_batch_bytes_per_example=wire.batch_nbytes(host) / b.n,
                **per_ministep(rec), wall_s=rec["wall_s"],
                hashed_wall_s=runs["hashed"]["wall_s"],
                examples_per_s_e2e=sum(rec["examples"]) / rec["wall_s"])


def tau_path(tmp: str, seed: int) -> dict:
    """``configs/ctr/online_l1lr.conf`` with adaptive τ (set after the
    parse: the reference's parser reads no ``tau_adaptive``) through the
    CLI, one pass over ``TAU_ROWS`` rows, on the card and on the CPU: the
    same τ trajectory."""
    write_ctr_shards(os.path.join(tmp, "tau"), 1, TAU_ROWS, seed)
    parse = linear_main.parse_conf

    def adaptive(text):
        c = parse(text)
        c.async_sgd.tau_adaptive = True
        return c

    linear_main.parse_conf = adaptive
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            text = ctr_conf(os.path.join(tmp, "tau", "part.*"), os.path.join(tmp, f"tau_{dev}"),
                            num_data_pass=1)
            reset_counts()
            runs[dev] = run_cli(text, os.path.join(tmp, f"tau_{dev}.conf"), dev)
            runs[dev]["launches"] = counts()
    finally:
        linear_main.parse_conf = parse
    traces = {d: r["worker"]._consistency.controller.tau_trace for d, r in runs.items()}
    check(traces["cuda"] == traces["cpu"], f"adaptive tau: card {traces['cuda']} vs CPU {traces['cpu']}")
    check(max(traces["cuda"]) > 1, f"adaptive tau never widened: {traces['cuda']}")
    card = runs["cuda"]
    n = card["ministeps"]
    check(card["launches"] == (0, n, n, 2 * n), f"adaptive tau launch counts {card['launches']}")
    return dict(ministeps=n, tau_trace=traces["cuda"], dense_launches=n, quantize_launches=n,
                episodes=card["worker"]._consistency.controller.episodes,
                examples_per_s_e2e=sum(card["examples"]) / card["wall_s"],
                step_ms_per_ministep=card["step_s"] / n * 1e3,
                objective_first=card["objective"][0], objective_last=card["objective"][-1])


BIGTABLE_CONF = os.path.join(ROOT, "configs", "criteo", "online_l1lr_bigtable.conf")


def bigtable_path(tmp: str, seed: int) -> dict:
    """``configs/criteo/online_l1lr_bigtable.conf`` through the CLI at its
    2^30 slots, bf16 √n, T 8, τ 4, the tail filter, on generated Criteo
    text cut as the Criteo cell is (``CRITEO_SHARDS`` x ``CRITEO_ROWS``
    rows, one pass): ``update: auto`` takes the sparse exact path; the
    loss finite and falling, the model written, the peak memory."""
    data = os.path.join(tmp, "criteo")
    if not os.path.isdir(data):
        write_criteo_shards(data, CRITEO_SHARDS, CRITEO_ROWS, seed)
    model = os.path.join(tmp, "bigtable")
    with open(BIGTABLE_CONF) as f:
        text = ctr_conf(os.path.join(data, "part.*"), model, conf_text=f.read())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rec = run_cli(text, os.path.join(tmp, "bigtable.conf"), "cuda", seed)
    got = counts()
    w = rec.pop("worker")
    n = rec["ministeps"]
    check(w.num_slots == 1 << 30 and w._update_mode == "sparse" and w.update_path == "cuda_sparse"
          and w.state["sqrt_n"].dtype == torch.bfloat16 and w.sgd.steps_per_launch == 8,
          f"bigtable worker: {w.num_slots} slots, {w._update_mode}, {w.update_path}")
    check(got == (n, 0, 0, 2 * n), f"bigtable launch counts {got}, want {n}/0/0/{2 * n}")
    obj = rec["objective"]
    check(all(np.isfinite(obj)) and obj[-1] < obj[0], f"bigtable objective {obj}")
    nz = model_nonzeros(model + "_S0")
    check(nz > 0, "bigtable: an empty model")
    examples = sum(rec["examples"])
    return dict(num_slots=w.num_slots, ministeps=n, sparse_launches=got[0], segment_launches=got[3],
                examples=examples, examples_per_s_e2e=examples / rec["wall_s"], wall_s=rec["wall_s"],
                **per_ministep(rec), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                objective_first=obj[0], objective_last=obj[-1], model_nonzeros=nz)


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


def print_segment_row(r: dict, smi: str) -> None:
    route = "no sort (ids grouped)" if r["presorted"] else "stable sort first"
    print(f"# parity segment_sum {r['case']} ({r['entries']} entries, {r['live']} nonzero, "
          f"{r['segments']} segments, longest run {r['longest']}; {route}): card bit-equal to "
          f"the CPU, run to run; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, whole "
          f"sum {r['whole_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, bytes "
          f"{r['bytes_ms']:.4f} ms, serial floor {r['serial_floor_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]", flush=True)


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
TAU_ROWS = 300_000  # 30 minibatches: adaptive τ widens from 1 to the cap 4
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
        rec["ministeps"] += prepped.steps if isinstance(prepped, async_sgd._SUPERBATCHES) else 1
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
    # one objective a submission (a T-ministep launch, or one ministep)
    rec["objective"] = [o / e for o, e in zip(w.progress.objective, rec["examples"])]
    check(len(rec["objective"]) == len(rec["examples"]) > 0 and all(np.isfinite(rec["objective"])),
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


# -- phase 5b: the darlin app (block coordinate descent) --

DARLIN_SHARDS, DARLIN_ROWS = 4, 250_000  # the Criteo batch conf's data: 1M rows, 39M entries
DARLIN_EVAL_ROWS = 100_000
DARLIN_AGREE_ROWS = 50_000  # the Criteo batch conf cut for card vs CPU and run to run
# card vs CPU: the segment sums add in the same order on both, but the
# card's exp is not the CPU's, so the dual (and every pass's objective)
# parts in the last bits; a KKT decision that sits on such a bit may
# flip, so nnz(w), the active set and the model's keys may lie this share
# of the columns apart (the counts are printed)
DARLIN_OBJ_RTOL = 1e-5
DARLIN_COUNT_TOL = 1e-3
BATCH_CONF = {name: os.path.join(ROOT, "configs", name, "batch_l1lr.conf")
              for name in ("criteo", "ctr")}
EVAL_BATCH_CONF = {name: os.path.join(ROOT, "configs", name, "eval_batch.conf")
                   for name in ("criteo", "ctr")}


@contextlib.contextmanager
def timed_darlin():
    """Times the stages of every darlin run made inside, on the host
    clock: load and localize (``load_data``), the upload (``init_data``,
    to a synchronize) and the passes (``_run_passes``, to a
    synchronize); keeps each scheduler. Yields the record it fills."""
    sched_cls, solver_cls = darlin.DarlinScheduler, darlin.DarlinSolver
    rec = dict(load_s=0.0, init_s=0.0, passes_s=0.0, scheds=[])
    orig = dict(init=sched_cls.__init__, load_data=sched_cls.load_data,
                run_passes=sched_cls._run_passes, init_data=solver_cls.init_data)

    def sync(device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def init(self, *a, **k):
        orig["init"](self, *a, **k)
        rec["scheds"].append(self)

    def load_data(self, *a, **k):
        t0 = time.perf_counter()
        out = orig["load_data"](self, *a, **k)
        rec["load_s"] += time.perf_counter() - t0
        return out

    def init_data(self, *a, **k):
        t0 = time.perf_counter()
        out = orig["init_data"](self, *a, **k)
        sync(self.device)
        rec["init_s"] += time.perf_counter() - t0
        return out

    def run_passes(self, *a, **k):
        t0 = time.perf_counter()
        out = orig["run_passes"](self, *a, **k)
        sync(self.solver.device)
        rec["passes_s"] += time.perf_counter() - t0
        return out

    patches = [(sched_cls, "__init__", init), (sched_cls, "load_data", load_data),
               (sched_cls, "_run_passes", run_passes), (solver_cls, "init_data", init_data)]
    for owner, name, fn in patches:
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for (owner, name, _), key in zip(patches, orig):
            setattr(owner, name, orig[key])


def run_darlin(conf_text: str, path: str, device: str) -> dict:
    """The port's CLI on a darlin conf, its counts zeroed before and read
    after; returns the timed record with the scheduler, its progress lines
    and the launch counts."""
    with open(path, "w") as f:
        f.write(conf_text)
    out = io.StringIO()
    reset_counts()
    with timed_darlin() as rec, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = linear_main.main([path], device=device)
        rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = counts() + (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                                  fa.flash_bwd_dkv.launches)
    check(rc == 0, f"CLI on {path} ({device}) exited {rc}")
    (sched,) = rec.pop("scheds")
    lines = out.getvalue().splitlines()
    rec.update(sched=sched, progress=[x for x in lines if x.startswith("iter ")],
               model=sched.conf.model_output.file[0] + "_S0")
    prog = [sched.g_progress[i] for i in sorted(sched.g_progress)]
    steps = len(sched.fea_blk) * len(prog)
    check(len(prog) > 0 and rec["progress"][:len(prog)] == [sched.show_progress(i) for i in
                                                               sorted(sched.g_progress)],
          f"darlin {path} ({device}): progress lines {rec['progress'][:3]}")
    check(all(np.isfinite(p.objective) for p in prog), f"darlin {path}: objectives not finite")
    want = (0, 0, 0, 3 * steps if device == "cuda" else 0, 0, 0, 0)
    check(rec["launches"] == want, f"darlin {path} ({device}): launches (sparse, dense, quantize, "
          f"segment_sum, flash fwd/dq/dkv) {rec['launches']}, want {want} ({steps} block steps)")
    rec.update(block_steps=steps, objectives=[p.objective for p in prog])
    return rec


def model_keys(path: str) -> dict:
    """key -> weight of a darlin model file; every weight finite and nonzero."""
    with open(path) as f:
        rows = [line.split("\t") for line in f.read().splitlines()]
    model = {k: float(v) for k, v in rows}
    check(len(model) == len(rows) and all(np.isfinite(v) and v != 0 for v in model.values()),
          f"{path}: a repeated key, a zero or a non-finite weight")
    return model


def block_times(solver, ns_per_add: float) -> dict:
    """Each block's step, timed alone on the solver's final state
    (``benchmarks/timing.py``: cold L2), one step's aten operations and
    segment-sum launches, and its sums at the slowest and the median
    block as ``segment_case`` rows (card bit-equal to the CPU, the
    kernel's time beside its plain version, ``index_add_`` and the
    bound)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            CountOps.ops += 1
            return func(*args, **(kwargs or {}))

    def step(b):
        return lambda: darlin.block_step(
            solver.w_blk[b], solver.delta_blk[b], solver.active_blk[b], solver.dual, solver.y,
            solver.row_mask, solver.blocks[b], 1e-3, solver.lam, solver.eta,
            solver.bcd.delta_max_value)

    def sums(b, which):
        """The step's sum by column (G's; U's has the same ids) and its sum
        by row, on the block's inputs."""
        blk = solver.blocks[b]
        tau = 1.0 / (1.0 + solver.dual)
        by_col = -solver.y[blk.rows] * tau[blk.rows] * blk.vals
        by_row = blk.vals_by_row * solver.w_blk[b][blk.cols_by_row]
        return [segment_case(f"darlin {which} block's sum by column", by_col, blk.cols,
                             blk.num_cols, True, ns_per_add),
                segment_case(f"darlin {which} block's sum by row", by_row, blk.rows_by_row,
                             solver.dual.numel(), True, ns_per_add)]

    ms = [median_ms(step(b), reps=5) for b in range(len(solver.blocks))]
    slowest, median = int(np.argmax(ms)), int(np.argsort(ms)[len(ms) // 2])
    before = seg.segment_sum.launches
    with CountOps():
        step(slowest)()
    torch.cuda.synchronize()
    launches = seg.segment_sum.launches - before
    t0 = time.perf_counter()
    solver.evaluate()
    evaluate_ms = (time.perf_counter() - t0) * 1e3
    return dict(block_ms=ms, pass_device_ms=float(sum(ms)), median_block_ms=float(ms[median]),
                max_block_ms=float(ms[slowest]), aten_ops_a_step=CountOps.ops,
                segment_launches_a_step=launches, evaluate_ms=evaluate_ms,
                segment_rows=sums(slowest, "slowest") + sums(median, "median"))


def darlin_summary(rec: dict) -> dict:
    sched = rec["sched"]
    last = sched.g_progress[max(sched.g_progress)]
    passes = len(sched.g_progress)
    return dict(rows=sched.data.n, entries=sched.data.nnz, columns=sched.data.cols,
                blocks=len(sched.fea_blk), passes=passes, block_steps=rec["block_steps"],
                objective_first=rec["objectives"][0], objective_last=rec["objectives"][-1],
                nnz_w=last.nnz_w, active=last.nnz_active_set, violation=last.violation,
                max_dispatch_window=sched.max_dispatch_window,
                max_in_flight_observed=sched.max_in_flight_observed,
                load_s=rec["load_s"], init_s=rec["init_s"], passes_s=rec["passes_s"],
                wall_s=rec["wall_s"], block_steps_per_s=rec["block_steps"] / rec["passes_s"],
                segment_launches=rec["launches"][3])


def darlin_eval(tmp: str, name: str, write, rows: int, seed: int, model: str) -> dict:
    """``eval_batch.conf`` of the set through the CLI on the card, on
    held-out rows and the darlin model: one segment-sum launch a
    minibatch, the model's weights all loaded."""
    data = os.path.join(tmp, f"{name}_batch_test")
    write(data, 1, rows, seed)
    text = eval_conf(EVAL_BATCH_CONF[name], os.path.join(data, "part.*"), model.replace("_S0", "_S*"))
    reset_counts()
    ev = run_eval(text, os.path.join(tmp, f"eval_batch_{name}.conf"), "cuda")
    mb = -(-rows // model_evaluation.MINIBATCH)
    m = ev["metrics"]
    check(counts() == (0, 0, 0, mb) and m["num_examples"] == rows and m["auc"] > 0.5
          and all(np.isfinite(list(m.values()))) and ev["num_weights"] == len(model_keys(model)),
          f"darlin eval {name}: launches {counts()}, metrics {m}, {ev['num_weights']} weights")
    return dict(rows=rows, auc=m["auc"], logloss=m["logloss"], accuracy=m["accuracy"],
                line=ev["line"], wall_s=ev["wall_s"], segment_launches=mb)


def darlin_path(tmp: str, seed: int, ns_per_add: float) -> dict:
    """The darlin app through the CLI on the card: the Criteo batch conf
    on 1M generated rows and its eval, the CTR batch conf and its eval,
    then the Criteo conf cut to 50,000 rows on the card twice (w and the
    dual bit-identical) and on the CPU (the stated tolerances)."""
    out = {}
    crit_data = os.path.join(tmp, "criteo_batch")
    t0 = time.perf_counter()
    write_criteo_shards(crit_data, DARLIN_SHARDS, DARLIN_ROWS, seed)
    out["criteo_write_s"] = time.perf_counter() - t0
    text = ctr_conf(os.path.join(crit_data, "part.*"), os.path.join(tmp, "model", "criteo_batch"),
                    conf_text=open(BATCH_CONF["criteo"]).read())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the earlier phases' tensors still alive
    rec = run_darlin(text, os.path.join(tmp, "criteo_batch.conf"), "cuda")
    crit = darlin_summary(rec)
    crit["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    sched = rec["sched"]
    check(crit["objective_last"] < crit["objective_first"] and crit["blocks"] == 39
          and sched.solver.lam == 4.0 and sched.bcd_conf.max_block_delay == 2
          and crit["max_dispatch_window"] >= 2,
          f"darlin Criteo: {crit}")
    crit.update(block_times(sched.solver, ns_per_add), progress=rec["progress"])
    crit["eval"] = darlin_eval(tmp, "criteo", write_criteo_shards, DARLIN_EVAL_ROWS, seed + 7,
                               rec["model"])
    out["criteo"] = crit
    del rec, sched
    torch.cuda.empty_cache()

    ctr_data = os.path.join(tmp, "ctr_batch")
    write_ctr_shards(ctr_data, CTR_SHARDS, CTR_ROWS, seed + 1)
    text = ctr_conf(os.path.join(ctr_data, "part.*"), os.path.join(tmp, "model", "ctr_batch"),
                    conf_text=open(BATCH_CONF["ctr"]).read())
    rec = run_darlin(text, os.path.join(tmp, "ctr_batch.conf"), "cuda")
    ctr = darlin_summary(rec)
    check(ctr["objective_last"] < ctr["objective_first"] and rec["sched"].bcd_conf.max_block_delay == 0
          and ctr["max_dispatch_window"] <= 1, f"darlin CTR: {ctr}")
    ctr["eval"] = darlin_eval(tmp, "ctr", write_ctr_shards, CTR_ROWS, seed + 8, rec["model"])
    out["ctr"] = ctr
    del rec

    agree_data = os.path.join(tmp, "criteo_agree")
    write_criteo_shards(agree_data, 1, DARLIN_AGREE_ROWS, seed + 9)
    runs = {}
    for run in ("cuda", "cuda_again", "cpu"):
        text = ctr_conf(os.path.join(agree_data, "part.*"), os.path.join(tmp, "model", f"agree_{run}"),
                        conf_text=open(BATCH_CONF["criteo"]).read())
        runs[run] = run_darlin(text, os.path.join(tmp, f"agree_{run}.conf"), run.split("_")[0])
    a, b, c = (runs[k]["sched"] for k in ("cuda", "cuda_again", "cpu"))
    bits = lambda x: np.ascontiguousarray(x).view(np.int32)  # noqa: E731
    check(np.array_equal(bits(a.solver.w), bits(b.solver.w))
          and torch.equal(a.solver.dual.view(torch.int32), b.solver.dual.view(torch.int32))
          and runs["cuda"]["progress"] == runs["cuda_again"]["progress"],
          "darlin: two card runs differ")
    card, cpu = runs["cuda"]["objectives"], runs["cpu"]["objectives"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(card, cpu))
    pa, pc = a.g_progress[max(a.g_progress)], c.g_progress[max(c.g_progress)]
    ka, kc = model_keys(runs["cuda"]["model"]), model_keys(runs["cpu"]["model"])
    bound = DARLIN_COUNT_TOL * a.data.cols
    apart = dict(nnz_w=abs(pa.nnz_w - pc.nnz_w), active=abs(pa.nnz_active_set - pc.nnz_active_set),
                 model_keys=len(set(ka) ^ set(kc)))
    check(len(card) == len(cpu) and rel <= DARLIN_OBJ_RTOL and max(apart.values()) <= bound,
          f"darlin card vs CPU: {len(card)} vs {len(cpu)} passes, objective {rel:.3g} apart "
          f"(bar {DARLIN_OBJ_RTOL}), counts apart {apart} (bar {bound:.0f})")
    common = sorted(set(ka) & set(kc))
    out["agree"] = dict(
        rows=a.data.n, passes=len(card), objective_rel_gap=rel, counts_apart=apart,
        count_bound=bound, columns=a.data.cols, nnz_w=pa.nnz_w, active=pa.nnz_active_set,
        max_abs_weight_diff=max((abs(ka[k] - kc[k]) for k in common), default=0.0),
        card_wall_s=runs["cuda"]["wall_s"], card_passes_s=runs["cuda"]["passes_s"],
        cpu_wall_s=runs["cpu"]["wall_s"], cpu_passes_s=runs["cpu"]["passes_s"],
        segment_launches=runs["cuda"]["launches"][3])
    return out


# -- phase 6: LM serving --

# flash_fwd against its plain version, (out rtol, out atol, lse atol); the
# reasons are in tests/test_torch_kernels_cuda.py: float32, 3xTF32 products
# and float32 sums in another order; in bf16 one ulp of the output, plus an absolute term for P rounded
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
    lse_readings = close(lse, plain_lse, 0.0, lse_tol, f"flash {name} lse")
    lse_err = lse_readings["max_abs"]
    check(bool(torch.isfinite(out.float()).all()), f"flash {name}: non-finite output")
    again, again_lse = fa.launch_kernel(*args, causal=True, window=window, group=group)
    torch.cuda.synchronize()
    deterministic = torch.equal(bits(again), bits(out)) and torch.equal(bits(again_lse), bits(lse))
    check(deterministic, f"flash {name}: two launches differ")
    del plain_out, plain_lse, again, again_lse
    gqa = {"enable_gqa": True} if group > 1 else {}
    nbytes, flops = flash_work(bh, sq, sk, d, group, q.element_size(), True, q_off, k_off, window)
    pairs = flops // (4 * d)
    b_ms, b_by = flash_bound(nbytes, flops, pairs, dtype)
    extra = {} if dtype == torch.bfloat16 else dict(cuda_core_ms=flops / F32_FLOP_PER_S * 1e3)
    ms = median_ms(lambda: fa.launch_kernel(*args, causal=True, window=window, group=group))
    return dict(**extra,
        case=name, bh=bh, sq=sq, sk=sk, d=d, dtype=str(dtype).split(".")[-1], q_off=q_off,
        k_off=k_off, window=window, group=group, max_abs_err=err, lse_err=lse_err, readings=readings,
        lse_readings=lse_readings,
        tolerance=dict(rtol=rtol, atol=atol, lse_atol=lse_tol), deterministic=deterministic,
        ms=ms, plain_ms=median_ms(lambda: fa._flash_plain(*args, True, window, group)),
        library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True, **gqa)),
        bound_ms=b_ms, bound_by=b_by, flop=flops, bytes=nbytes, tflop_per_s=flops / ms / 1e9,
        pairs=pairs,
    )


def f32_note(r: dict) -> str:
    """A float32 flash row's FLOP at the CUDA cores' rate (F32_FLOP_PER_S)."""
    if "cuda_core_ms" not in r:
        return ""
    return f"; at 67 TFLOP/s on the CUDA cores {r['cuda_core_ms']:.4f} ms"


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
# CLI_SMALL widened so that Adafactor factors every matrix (its second
# largest axis reaches min_dim_size_to_factor, 128)
CLI_FACTORED = ["--d-model", "128", "--n-heads", "2", "--d-ff", "256"]
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


def flash_bwd_times(gen, bh=32, s=8192, d=64, dtype=torch.bfloat16, plain_chunk=8,
                    mma_tflop_per_s=None) -> dict:
    """CUDA-event times of flash_bwd_dq and flash_bwd_dkv at one causal
    shape (by default the training shape, B*H 32, S 8192, D 64, bf16),
    beside the plain backward (dq, dk and dv together, run as B*H /
    plain_chunk calls: its float32 score tensors would not fit at once),
    SDPA's backward (``out.backward`` after an SDPA forward, ``is_causal``)
    and each kernel's bound (``flash_bound``: in float32 also the
    exponentials, one a kept pair in each kernel; and, given
    ``mma_tflop_per_s``, the three TF32 passes at mma.sync's measured
    rate); and flash_fwd beside SDPA's forward at the same shape."""
    q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype) for _ in range(4))
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
    elt = q.element_size()
    inputs = 4 * bh * s * d * elt + 2 * bh * s * 4  # q, k, v, do; lse, c
    dq_bound = flash_bound(inputs + bh * s * d * elt, 6 * d * pairs, pairs, dtype)  # S, dP, dQ
    dkv_bound = flash_bound(inputs + 2 * bh * s * d * elt, 8 * d * pairs, pairs, dtype)  # S, dP, dV, dK
    least = flash_bound(inputs + 3 * bh * s * d * elt, 10 * d * pairs, pairs, dtype)  # five products
    fwd_bound = flash_bound(*flash_work(bh, s, s, d, 1, elt, True, 0, 0, None), pairs, dtype)
    floors = {} if mma_tflop_per_s is None else dict(
        dq_mma_floor_ms=3 * 6 * d * pairs / (mma_tflop_per_s * 1e12) * 1e3,
        dkv_mma_floor_ms=3 * 8 * d * pairs / (mma_tflop_per_s * 1e12) * 1e3)
    return dict(**floors,
                bh=bh, s=s, d=d, dtype=str(dtype).split(".")[-1], pairs=pairs, dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
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


def run_lm_cli_records(argv) -> "tuple[str, list]":
    """The LM CLI as a user runs it, with ``--log-file``; returns its
    output and its log lines (losses to 6 decimals, wall_s)."""
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="lm_cli_") as tmp:
        log = os.path.join(tmp, "log.jsonl")
        with contextlib.redirect_stdout(buf):
            rc = lm_main.main(argv + ["--log-file", log])
        with open(log) as f:
            recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs]
    check(rc == 0, f"LM CLI {argv} exited {rc}")
    check(losses and all(np.isfinite(losses)), f"LM CLI {argv}: losses {losses}")
    return buf.getvalue(), recs


def run_lm_cli(argv) -> "tuple[str, list]":
    """The LM CLI as a user runs it; returns its output and the losses of
    its log lines (6 decimals)."""
    text, recs = run_lm_cli_records(argv)
    return text, [r["loss"] for r in recs]


def lm_cli(seed: int) -> dict:
    """The LM CLI: a small float32 run on the card against the CPU, then
    the full config to a falling loss and a generation."""
    reset_counts()
    _, card = run_lm_cli(CLI_SMALL + ["--device", "cuda"])
    small = (fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    check(min(small) > 0 and small[1] == small[2],
          f"LM CLI float32 on the card: launches (flash_fwd, dq, dkv) {small}")
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
    return dict(small_card=card, small_cpu=cpu, small_gap=gap, small_launches=small,
                losses=losses, wall_s=wall,
                launches=got, generation=gen[1].split("\n", 1)[1])


# -- phase 7b: the rest of the LM family --

# the serving config with every second layer a mixture of 8 experts; at
# capacity factor 8 (= n_experts) training never drops a token, so the
# dropless serving FFN must give the training forward's logits
MOE_SERVE_CFG = dataclasses.replace(lm_serve.SERVE_CFG, moe_every=2, n_experts=8,
                                    capacity_factor=8.0)
MOE_STEPS = 64
# script/onchip.py's beam capture: width 4, batch 8, 2048-token prompts, 128 steps
BEAM_WIDTH, BEAM_STEPS, BEAM_GREEDY_STEPS = 4, 128, 64
TURN_TOKENS, TURN_STEPS = 64, 64  # the later turns of a conversation, and each turn's steps
CLI_MOE_STEPS = 10


@contextlib.contextmanager
def first_call(name: str):
    """Records the arguments of the first call of ``fa.<name>`` inside the
    block (tensors cloned), so that the kernel can be held against its
    plain version on a path's own inputs once the path's counts are read.
    ``name`` is a route that counts no launches on itself
    (``launch_kernel`` counts on ``flash_attention``; ``_backward`` calls
    the counted backward pair), so the counts are untouched."""
    orig = getattr(fa, name)
    check(not hasattr(orig, "launches"), f"first_call: fa.{name} counts launches on itself")
    seen = []

    def wrapper(*args, **kw):
        if not seen:
            seen.append(([a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args],
                         dict(kw)))
        return orig(*args, **kw)

    setattr(fa, name, wrapper)
    try:
        yield seen
    finally:
        setattr(fa, name, orig)


def hold_forward(seen, what: str) -> dict:
    """flash_fwd against its plain version on the first inputs a path gave
    it (FLASH_TOL)."""
    check(len(seen) == 1, f"{what}: flash_fwd was not launched")
    (q, k, v, q_off, k_off), kw = seen[0]
    out, lse = fa.launch_kernel(q, k, v, q_off, k_off, **kw)
    plain_out, plain_lse = fa._flash_plain(q, k, v, q_off, k_off, kw["causal"], kw["window"],
                                           kw["group"])
    rtol, atol, lse_tol = FLASH_TOL[q.dtype]
    r = close(out, plain_out, rtol, atol, f"{what} flash_fwd out")
    r_lse = close(lse, plain_lse, 0.0, lse_tol, f"{what} flash_fwd lse")
    return dict(bh=q.shape[0], sq=q.shape[1], sk=k.shape[1], d=q.shape[2], group=kw["group"],
                dtype=str(q.dtype).split(".")[-1], max_abs_err=r["max_abs"],
                lse_err=r_lse["max_abs"], tolerance_used=max(r["tolerance_used"],
                                                             r_lse["tolerance_used"]))


def hold_backward(seen, what: str, rows: int = 8) -> dict:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward on the
    first inputs a path gave the autograd Function's backward
    (``fa._backward``), cut to ``rows`` query rows (the plain version's
    float32 score tensors of all of them would not fit; phase 7 holds the
    pair at the full training shape); tolerance FLASH_BWD_TOL as a share
    of each gradient's scale."""
    check(len(seen) == 1, f"{what}: the flash backward was not called")
    (q, k, v, do, lse, c, q_off, k_off, causal, window, g), _ = seen[0]
    kw = dict(causal=causal, window=window, group=g)
    n = min(rows, q.shape[0])
    q, do, lse, c, k, v = q[:n], do[:n], lse[:n], c[:n], k[:n // g], v[:n // g]
    got = (fa.flash_bwd_dq(q, k, v, do, lse, c, q_off, k_off, **kw),
           *fa.flash_bwd_dkv(q, k, v, do, lse, c, q_off, k_off, **kw))
    with torch.no_grad():
        want = fa.flash_attention_bwd_ref(q, k, v, do, lse, c, q_off, k_off, **kw)
    rtol, share = FLASH_BWD_TOL[q.dtype]
    out = dict(bh=n, sq=q.shape[1], sk=k.shape[1], d=q.shape[2], dtype=str(q.dtype).split(".")[-1])
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        scale = max(float(y.float().abs().max()), 1e-30)
        out[name] = close(x, y, rtol, share * scale, f"{what} flash bwd {name}")["max_abs"]
    return out


def moe_serving(seed: int) -> dict:
    """(a) MoE serving at the serving config: greedy ``lm_generate``, the
    prefill held to the training forward and flash_fwd to its plain
    version on the prefill's own inputs."""
    cfg = MOE_SERVE_CFG
    b, p = lm_serve.B, lm_serve.P
    params = transformer.init_lm(seed, cfg, "cuda")
    prompt = lm_serve.make_prompt(seed + 3, device="cuda")
    transformer.lm_generate(params, prompt, cfg, 2)  # warm-up at the timed shapes
    reset_counts()
    with first_call("launch_kernel") as seen:
        first, ttft_s = timed_generate(params, prompt, cfg, 1)
    prefill_n = fa.flash_attention.launches
    check(prefill_n == cfg.n_layers, f"MoE prefill: {prefill_n} flash launches, want "
          f"{cfg.n_layers}")
    reset_counts()
    toks, wall_s = timed_generate(params, prompt, cfg, MOE_STEPS)
    flash_n = fa.flash_attention.launches
    check(flash_n == cfg.n_layers and counts() == (0, 0, 0, 0),
          f"MoE greedy: flash launches {flash_n}, others {counts()}; want {cfg.n_layers}, none")
    check_tokens(toks, prompt, MOE_STEPS, "MoE greedy")
    check(torch.equal(toks[:, p], first[:, p]), "MoE greedy: the first token differs from the "
          "steps=1 run")
    tol = NOISE_MULTIPLE * REF_BF16_NOISE
    _, served = transformer.lm_generate(params, prompt, cfg, 0, return_logits=True)
    with torch.no_grad():
        trained = transformer.lm_forward(params, prompt, cfg)[:, :-1]
    gap = float((served - trained).abs().max())
    check(bool(torch.isfinite(served).all()) and gap <= tol,
          f"MoE prefill logits vs the training forward: {gap} apart, tolerance {tol}")
    del served, trained
    return dict(batch=b, prompt=p, steps=MOE_STEPS, prefill_flash_launches=prefill_n,
                flash_launches=flash_n, ttft_ms=ttft_s * 1e3, generate_s=wall_s,
                decode_tokens_per_s=b * (MOE_STEPS - 1) / (wall_s - ttft_s),
                prefill_vs_forward_gap=gap, tolerance=tol,
                distinct_tokens=int(toks[:, p:].unique().numel()),
                flash_held=hold_forward(seen, "MoE prefill"))


def beam_path(seed: int) -> dict:
    """(b) beam search at the serving config: width 4 (onchip's shape),
    scores against teacher forcing through the training forward, width 1
    against greedy ``lm_generate``, beam tokens/s as onchip differences
    it (the 1-step call from the 128-step call)."""
    cfg = lm_serve.SERVE_CFG
    params = lm_serve.serve_params(seed, "cuda")
    prompt = lm_serve.make_prompt(seed + 4, device="cuda")
    b, p = prompt.shape

    def timed(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = transformer.lm_beam_search(params, prompt, cfg, steps, beam_width=BEAM_WIDTH)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed(1)  # warm-up
    reset_counts()
    with first_call("launch_kernel") as seen:
        _, short_s = timed(1)
    prefill_n = fa.flash_attention.launches
    # each step's kept scores and indices (parent * vocab + token), read
    # from the search's own top-k, to trace the best beam's terms back
    tops, top = [], transformer._top

    def recorded_top(x, k):
        out = top(x, k)
        tops.append(out)
        return out

    reset_counts()
    transformer._top = recorded_top
    try:
        (toks, scores), long_s = timed(BEAM_STEPS)
    finally:
        transformer._top = top
    flash_n = fa.flash_attention.launches
    check(prefill_n == flash_n == cfg.n_layers and counts() == (0, 0, 0, 0),
          f"beam: flash launches {prefill_n} / {flash_n}, others {counts()}; want {cfg.n_layers}")
    check(toks.shape == (b, BEAM_WIDTH, p + BEAM_STEPS) and scores.shape == (b, BEAM_WIDTH),
          f"beam: tokens {tuple(toks.shape)}, scores {tuple(scores.shape)}")
    check(torch.equal(toks[:, :, :p], prompt[:, None].expand(-1, BEAM_WIDTH, -1)),
          "beam: the prompt is not kept")
    check(bool(torch.isfinite(scores).all()) and bool((scores[:, 1:] <= scores[:, :-1]).all()),
          f"beam: scores not finite and best first {scores}")
    # each term of a score is a log-probability, a difference of two
    # values each within the logit tolerance of the reference: the best
    # beam's term at every step against teacher forcing of its tokens
    per_token = 2 * NOISE_MULTIPLE * REF_BF16_NOISE
    check(len(tops) == BEAM_STEPS, f"beam: {len(tops)} top-k calls, want {BEAM_STEPS}")
    rows = torch.arange(b, device="cuda")
    j = torch.zeros(b, dtype=torch.int64, device="cuda")  # the best beam, ranked first
    terms = torch.empty((b, BEAM_STEPS), device="cuda")
    traced = torch.empty((b, BEAM_STEPS), dtype=torch.int64, device="cuda")
    for s in range(BEAM_STEPS - 1, -1, -1):
        vals, idx = tops[s]
        if s == 0:
            terms[:, 0], traced[:, 0] = vals[rows, j], idx[rows, j]
        else:
            parent = idx[rows, j] // cfg.vocab
            terms[:, s] = vals[rows, j] - tops[s - 1][0][rows, parent]
            traced[:, s] = idx[rows, j] % cfg.vocab
            j = parent
    best = toks[:, 0]
    check(torch.equal(traced, best[:, p:]), "beam: the traced best beam is not its tokens")
    with torch.no_grad():
        logp = torch.log_softmax(transformer.lm_forward(params, best, cfg).float(), -1)
    forced_terms = logp[:, p - 1:-1].gather(-1, best[:, p:, None])[..., 0]
    forced = forced_terms.sum(-1)
    term_gap = float((terms - forced_terms).abs().max())
    gap = float((scores[:, 0] - forced).abs().max())
    check(term_gap <= per_token, f"beam: the best beams' terms vs teacher forcing {term_gap} "
          f"apart at worst, tolerance {per_token}")
    # a reading of the check's reach: the best beam's tokens scored in the
    # runner-up's context, as a cache handed to the wrong beam would score
    # them (0 where the two histories agree)
    with torch.no_grad():
        logp = torch.log_softmax(transformer.lm_forward(params, toks[:, 1], cfg).float(), -1)
    wrong_gap = float((logp[:, p - 1:-1].gather(-1, best[:, p:, None])[..., 0]
                       - forced_terms).abs().max())
    del logp
    one, _ = transformer.lm_beam_search(params, prompt, cfg, BEAM_GREEDY_STEPS, beam_width=1)
    greedy = transformer.lm_generate(params, prompt, cfg, BEAM_GREEDY_STEPS)
    check(torch.equal(one[:, 0], greedy), "beam width 1 differs from greedy lm_generate")
    beam_s = long_s - short_s
    noisy = beam_s < 0.2 * long_s
    return dict(batch=b, prompt=p, steps=BEAM_STEPS, width=BEAM_WIDTH, flash_launches=flash_n,
                short_s=short_s, long_s=long_s, diff_noisy=noisy,
                tokens_per_s=b * (BEAM_STEPS - 1) / (long_s if noisy else beam_s),
                best_scores=scores[:, 0].tolist(), teacher_forced=forced.tolist(),
                teacher_forced_term_gap=term_gap, tolerance=per_token, teacher_forced_gap=gap,
                runner_up_context_gap=wrong_gap,
                width_one_is_greedy_steps=BEAM_GREEDY_STEPS,
                flash_held=hold_forward(seen, "beam prefill"))


def continuation_path(seed: int) -> dict:
    """(c) three turns at the serving config: a 2048-token prompt and 64
    steps, a 64-token turn and 64 steps, an ingest-only 64-token turn then
    64 steps; each later turn's tokens against single-shot
    ``lm_generate`` over the whole history (``token_agreement``)."""
    cfg = lm_serve.SERVE_CFG
    params = lm_serve.serve_params(seed, "cuda")
    prompt = lm_serve.make_prompt(seed + 5, device="cuda")
    b, p = prompt.shape
    rng = np.random.default_rng(seed + 6)
    turn2, turn3 = (torch.as_tensor(rng.integers(0, cfg.vocab, (b, TURN_TOKENS)), device="cuda")
                    for _ in range(2))
    cap = p + TURN_STEPS + 2 * (TURN_TOKENS + TURN_STEPS)
    reset_counts()
    with first_call("launch_kernel") as seen:
        out1, state = transformer.lm_generate(params, prompt, cfg, TURN_STEPS, return_state=True,
                                              max_len=cap)
    first_n = fa.flash_attention.launches
    check(first_n == cfg.n_layers, f"first turn: {first_n} flash launches, want {cfg.n_layers}")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen2, state = transformer.lm_generate_continue(params, state, cfg, TURN_STEPS, new_tokens=turn2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    empty, state = transformer.lm_generate_continue(params, state, cfg, 0, new_tokens=turn3)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gen3, state = transformer.lm_generate_continue(params, state, cfg, TURN_STEPS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    later_n = fa.flash_attention.launches
    check(later_n == 0 and counts() == (0, 0, 0, 0), f"later turns: flash launches {later_n}, "
          f"others {counts()}; the caches serve them, want none")
    check(empty.shape == (b, 0) and state.length == cap, f"continuation: state length "
          f"{state.length}, want {cap}")
    tol = NOISE_MULTIPLE * REF_BF16_NOISE
    hist2 = torch.cat([out1, turn2], 1)
    hist3 = torch.cat([hist2, gen2, turn3], 1)
    agree = {}
    for name, hist, gen in (("turn 2", hist2, gen2), ("turn 3 after ingest-only", hist3, gen3)):
        ref_toks, ref_logits = transformer.lm_generate(params, hist, cfg, TURN_STEPS,
                                                       return_logits=True)
        agree[name] = token_agreement(ref_toks, ref_logits, torch.cat([hist, gen], 1), None,
                                      hist.shape[1], tol, f"continuation {name} vs single shot")
        del ref_logits
    return dict(batch=b, prompt=p, turn_tokens=TURN_TOKENS, steps=TURN_STEPS,
                first_turn_flash_launches=first_n, later_flash_launches=later_n,
                turn2_s=t1 - t0, ingest_only_s=t2 - t1, turn3_s=t3 - t2, agreement=agree,
                tolerance=tol, flash_held=hold_forward(seen, "first turn"))


def family_cli(seed: int) -> dict:
    """(d) the LM CLI: the full config with MoE layers for 10 Adam steps
    and a beam of 4; Adafactor (at a width where it factors its second
    moments) and Lion, card against CPU; a checkpointed run resumed, card
    against CPU."""
    n_layers = lm_train.TRAIN_CFG.n_layers
    argv = CLI_FULL + ["--moe-every", "2", "--steps", str(CLI_MOE_STEPS), "--report-every", "1",
                       "--beam", "4", "--seed", str(seed)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with first_call("_backward") as seen:
        text, recs = run_lm_cli_records(argv)
    got = (fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    want = (2 * n_layers * CLI_MOE_STEPS + n_layers, n_layers * CLI_MOE_STEPS,
            n_layers * CLI_MOE_STEPS)
    check(got == want, f"MoE CLI launches (flash_fwd, dq, dkv) {got}, want {want} (10 steps of "
          "8 layers under remat, and the beam's prefill)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [r["loss"] for r in recs]
    check(len(losses) == CLI_MOE_STEPS and losses[-1] < losses[0],
          f"MoE CLI: loss did not fall {losses}")
    beam = text.split("--- generation (64 tokens, beam 4, logprob ", 1)
    check(len(beam) == 2 and len(beam[1].splitlines()) >= 2, "MoE CLI: no beam generation")
    for line in text.splitlines():
        print(f"# cli moe | {line}", flush=True)
    # the first step carries the warm-up: the step time is the later steps'
    step_ms = (recs[-1]["wall_s"] - recs[0]["wall_s"]) / (len(recs) - 1) * 1e3
    held = hold_backward(seen, "MoE CLI")
    optimizers = {}
    for opt, width in (("adafactor", CLI_FACTORED), ("lion", [])):
        argv = CLI_SMALL + width + ["--optimizer", opt]
        reset_counts()
        _, card = run_lm_cli(argv + ["--device", "cuda"])
        launches = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                    fa.flash_bwd_dkv.launches)
        check(min(launches) > 0, f"LM CLI {opt} on the card: launches {launches}")
        _, cpu = run_lm_cli(argv + ["--device", "cpu"])
        gap = max(abs(a - b) for a, b in zip(card, cpu))
        check(len(card) == len(cpu) == 5 and gap <= CLI_LOSS_TOL,
              f"LM CLI {opt}: card {card} vs CPU {cpu}: {gap} apart, tolerance {CLI_LOSS_TOL}")
        optimizers[opt] = dict(card=card, cpu=cpu, gap=gap, launches=launches)
    optimizers["adafactor"]["factored_leaves"] = factored = factored_leaves(CLI_FACTORED)
    check(factored[0] > 0, f"LM CLI adafactor: no leaf factored {factored}")
    # the JAX CLI's resume: the counters and optimizer state go on from the
    # checkpoint and the batch stream starts over from the seed, so steps
    # 6-10 see the batches of steps 1-5; held card against CPU, and against
    # the fresh run on the same batches (a run that restored nothing would
    # repeat its first loss)
    resumed = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as ck:
            _, fresh = run_lm_cli(CLI_SMALL + ["--device", dev, "--ckpt-dir", ck])
            text_r, resumed[where] = run_lm_cli(CLI_SMALL + ["--device", dev, "--ckpt-dir", ck,
                                                             "--resume", "--steps", "10"])
        check("resumed from step 5" in text_r and len(resumed[where]) == 5
              and fresh[0] - resumed[where][0] > CLI_LOSS_TOL,
              f"LM CLI resume on the {where}: steps 6-10 {resumed[where]}, the fresh run's {fresh}")
    resume_gap = max(abs(a - b) for a, b in zip(resumed["card"], resumed["cpu"]))
    check(resume_gap <= CLI_LOSS_TOL, f"LM CLI resume: card {resumed['card']} vs CPU "
          f"{resumed['cpu']}: {resume_gap} apart, tolerance {CLI_LOSS_TOL}")
    return dict(moe=dict(losses=losses, step_ms=step_ms, peak_gib=peak_gib, launches=got,
                         beam_generation=beam[1].split("\n", 1)[1], flash_bwd_held=held),
                optimizers=optimizers, resumed=resumed, resume_gap=resume_gap)


def factored_leaves(width) -> "tuple[int, int]":
    """The CLI's parameters at ``CLI_SMALL + width`` whose second moment
    the CLI's Adafactor factors, and all its parameters: read from the
    optimizer's own state for them (a factored leaf keeps a one-element
    full moment)."""
    flags = dict(zip(CLI_SMALL[0::2], CLI_SMALL[1::2]))
    flags.update(zip(width[0::2], width[1::2]))
    cfg = transformer.LMConfig(vocab=256, d_model=int(flags["--d-model"]),
                               n_heads=int(flags["--n-heads"]), n_layers=int(flags["--n-layers"]),
                               d_ff=int(flags["--d-ff"]))
    params = transformer.init_lm(0, cfg, "cpu")
    v = optim.build(3e-3, 5, optimizer="adafactor").init(params)["v"]
    return sum(v[k].numel() == 1 < p.numel() for k, p in params.items()), len(params)


def lm_family(seed: int) -> dict:
    """Phase 7b: MoE serving, beam search, multi-turn continuation and the
    LM CLI's MoE, Adafactor, Lion, checkpoint and beam flags."""
    return dict(moe_serving=moe_serving(seed), beam=beam_path(seed),
                continuation=continuation_path(seed), cli=family_cli(seed))


# -- the serving plane (apps/serve/main.py): phases A-D --------------------

SERVE_SLOTS = 1 << 22  # the table of the Criteo conf and of bench.py
SERVE_KEY_SPACE = 1 << 24  # the serve CLI's default key space
SERVE_BIG_SLOTS = 1 << 30  # configs/criteo/online_l1lr_bigtable.conf
SERVE_HOST_BUDGET = 2 << 30  # half the 2^30 table's 4 GiB
SERVE_PARITY_REQUESTS = 512  # the CLI's request pool, every row once
SERVE_DEVICE = "cuda"
# decode_batching_ab's full shapes (the JAX package's
# benchmarks/components.py, its non-smoke branch)
BATCH_TCFG = dict(vocab=256, d_model=512, n_heads=8, n_layers=2, d_ff=1024)
BATCH_DCFG = dict(vocab=256, d_model=128, n_heads=2, n_layers=1, d_ff=256)
BATCH_GAMMA, BATCH_PROMPT, BATCH_STEPS = 2, 8, (40, 48)
BATCH_SLOTS, BATCH_SESSIONS_A_SLOT = (1, 4, 8, 16), 6


def run_serve_cli(argv) -> "list[dict]":
    """``apps.serve.main.main(argv)`` in this process; its JSON records."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main.main(argv)
    check(rc == 0, f"serve CLI {argv} exited {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def serve_cli_path(seed: int) -> dict:
    """Phase A: the serve CLI through ``main()`` on the card at 2^22
    slots, every other flag at its default, three replica modes. Each
    run's launches are counted from zero."""
    runs = {}
    for name, extra in (("full", ["--replica", "full", "--train-while-serving", "--decode",
                                  "--batch-slots", "8"]),
                        ("hot", ["--replica", "hot"]),
                        ("off", ["--replica", "off"])):
        reset_counts()
        t0 = time.perf_counter()
        recs = run_serve_cli(["--num-slots", str(SERVE_SLOTS), "--seed", str(seed),
                              "--device", SERVE_DEVICE] + extra)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        by = {}
        for r in recs:
            by.setdefault(r["metric"], []).append(r)
        points = by["serve_open_loop_point"]
        check(len(points) == 2, f"serve {name}: {len(points)} load points")
        for p in points:
            check(p["n_errors"] == 0, f"serve {name}: errors at {p['offered_rate']}/s: {p['errors']}")
            check(p["completed"] == p["accepted"],
                  f"serve {name}: completed {p['completed']} != admitted {p['accepted']}")
        check(points[-1]["shed_frac"] > 0, f"serve {name}: the 3x point shed nothing")
        stats = by["serve_frontend_stats"][0]
        check(stats["degraded_served"] == 0,
              f"serve {name}: {stats['degraded_served']} degraded answers")
        launches = dict(flash_fwd=fa.flash_attention.launches, segment_sum=seg.segment_sum.launches)
        check(launches["segment_sum"] >= 1, f"serve {name}: the warm push launched no segment_sum")
        if name == "full":
            # one segment_sum a push: a stream that ran through both 3 s
            # load points pushes far more than 10 a second of the window
            # (the CLI itself fails if a push raised or hung)
            floor = 1 + 10 * sum(p["duration_s"] for p in points)
            check(launches["segment_sum"] >= floor,
                  f"serve full: {launches['segment_sum']} pushes, fewer than {floor:.0f} over "
                  "the load window: the push stream stalled")
            dec = by["serve_decode_latency_ms"][0]
            check(launches["flash_fwd"] > 0, "serve full: the decode lane launched no flash_fwd")
            check(dec["batcher"]["retired"] == 16, f"serve full: batcher retired {dec['batcher']}")
        runs[name] = dict(records=recs, capacity=by["serve_closed_loop_capacity"][0]["value"],
                          points=points, stats=stats, decode=by.get("serve_decode_latency_ms"),
                          launches=launches, wall_s=wall)
    return runs


def serve_values(kv, pool, hot, mode: str, device_replica: bool = False):
    """The values of every pool row through a frontend (pull) and the
    predict scores of 4-row CSR requests over the same rows."""
    fe = ServeFrontend(kv, ServeConfig(replica=mode, hot_keys=hot if mode == "hot" else None,
                                       replica_device=device_replica, workers=2)).start()
    try:
        pulls = [fe.submit(PullRequest(keys=row)) for row in pool]
        width = pool.shape[1] // 4
        preds = [fe.submit(PredictRequest(indices=row, indptr=np.arange(0, 4 * width + 1, width)))
                 for row in pool]
        vals = np.stack([t.result(120) for t in pulls])
        scores = np.stack([t.result(120) for t in preds])
        degraded = fe.degraded_served
    finally:
        fe.close()
    check(degraded == 0, f"serve {mode}: {degraded} degraded answers")
    return vals, scores


def serve_parity(seed: int) -> dict:
    """Phase B: the same seed and key pool on the card and on the CPU:
    the table after the warm push, and the values and predict scores of
    the pool's 512 requests through the frontend in each replica mode
    (and the device-resident replica), bit-equal."""
    out, tables = {}, {}
    for dev in (SERVE_DEVICE, "cpu"):
        kv, rng = serve_main.warm_store(SERVE_SLOTS, SERVE_KEY_SPACE, seed, dev)
        pool = serve_main.request_pool(rng, 32, SERVE_KEY_SPACE)
        hot = serve_main.hot_set(pool, 0.01, SERVE_KEY_SPACE)
        tables[dev] = kv.table(0, copy=True).cpu()
        for mode, on_card in (("full", False), ("hot", False), ("off", False), ("full", True)):
            if on_card and dev != SERVE_DEVICE:
                continue
            out[(dev, mode, on_card)] = serve_values(kv, pool, hot, mode, on_card)
        kv.executor.stop()
        kv.remove()  # the postoffice's manager holds every registered store
    check(torch.equal(bits(tables[SERVE_DEVICE]), bits(tables["cpu"])),
          "serve: the table after the warm push differs between the card and the CPU")
    cpu_vals, cpu_scores = out[("cpu", "full", False)]
    for (dev, mode, on_card), (vals, scores) in out.items():
        what = f"serve {dev} {mode}{' device replica' if on_card else ''}"
        check(np.array_equal(vals.view(np.uint32), cpu_vals.view(np.uint32)),
              f"{what}: pulled values differ from the CPU's")
        check(np.array_equal(scores.view(np.uint64), cpu_scores.view(np.uint64)),
              f"{what}: predict scores differ from the CPU's")
    nz = int((tables["cpu"] != 0).sum())
    warm = np.unique(np.random.default_rng(seed).integers(0, SERVE_KEY_SPACE, serve_main.WARM_KEYS))
    return dict(slots=SERVE_SLOTS, nonzero_slots=nz, requests=SERVE_PARITY_REQUESTS,
                modes=sorted({f"{m}{' device' if c else ''}" for _, m, c in out}),
                warm_keys=len(warm), keys_sharing_a_slot=len(warm) - nz)


def serve_bigtable(seed: int) -> dict:
    """Phase C: the device-resident replica at 2^30 slots (4 GiB f32)
    under a 2 GiB host budget: a host-mode refresh fails loudly; device
    mode serves through a stream of in-place pushes with no degraded
    answer. Refresh and gather times, peak device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kv, rng = serve_main.warm_store(SERVE_BIG_SLOTS, SERVE_KEY_SPACE, seed, SERVE_DEVICE)
    pool = serve_main.request_pool(rng, 32, SERVE_KEY_SPACE)
    try:
        ReadReplica(kv, host_budget_bytes=SERVE_HOST_BUDGET)
        host_refused = False
    except MemoryError as e:
        host_refused = "device=True" in str(e)
    check(host_refused, "serve bigtable: the host-mode refresh over budget did not fail loudly")
    torch.cuda.empty_cache()
    fe = ServeFrontend(kv, ServeConfig(replica="full", replica_device=True,
                                       replica_host_budget_bytes=SERVE_HOST_BUDGET,
                                       replica_refresh_s=0.25, workers=2)).start()
    stop = threading.Event()
    pushes = [0]
    push_err = []

    def pusher():
        try:
            i = 0
            while not stop.is_set():
                keys = np.unique(pool[i % len(pool)])
                kv.wait(kv.push(kv.request(channel=0), keys=keys,
                                values=np.ones((len(keys), 1), np.float32)))
                pushes[0] += 1
                i += 1
        except BaseException as e:
            push_err.append(e)

    t = threading.Thread(target=pusher, name="serve-big-pusher", daemon=True)
    t.start()
    served = 0
    t_end = time.monotonic() + 4.0
    try:
        while time.monotonic() < t_end:
            tickets = [fe.submit(PullRequest(keys=pool[(served + j) % len(pool)]))
                       for j in range(16)]
            for tk in tickets:
                v = tk.result(60)
                check(v.shape == (32, 1) and np.isfinite(v).all(), "serve bigtable: a bad answer")
            served += len(tickets)
    finally:
        stop.set()
        t.join(timeout=60)
    check(not push_err, f"serve bigtable: the push stream failed: {push_err[:1]}")
    stats = fe.stats()
    check(fe.degraded_served == 0, f"serve bigtable: {fe.degraded_served} degraded answers")
    check(stats["replica"]["device"] is True and stats["replica"]["version"] > 1,
          f"serve bigtable: replica {stats['replica']}")
    kv.executor.wait_all()
    refresh_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fe.replica.refresh()
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
    table = fe.replica._table
    gather = {}
    for n in (32, 4096):
        keys = np.unique(pool.ravel())[:n] if n <= pool.size else pool.ravel()[:n]
        keys = np.resize(keys, n)
        slots = torch.from_numpy(kv.channel(0).directory.slots(keys).astype(np.int64)).to(
            SERVE_DEVICE)
        gather[n] = median_ms(lambda: table.index_select(0, slots))
        t0 = time.perf_counter()
        for _ in range(20):
            fe.replica.pull(keys)
        gather[f"pull_{n}_host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    fe.close()
    kv.executor.stop()
    peak = torch.cuda.max_memory_allocated() - base
    kv.remove()  # the postoffice's manager holds every registered store
    del fe, kv, table, slots
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    check(left < 2 ** 30, f"serve bigtable: {left / 2 ** 30:.2f} GiB still held on the "
          "card after the phase (the 4 GiB table was not released)")
    return dict(slots=SERVE_BIG_SLOTS, table_gib=SERVE_BIG_SLOTS * 4 / 2 ** 30,
                host_budget_gib=SERVE_HOST_BUDGET / 2 ** 30, served=served, pushes=pushes[0],
                replica_version=stats["replica"]["version"], degraded_served=0,
                refresh_ms=refresh_ms, gather_ms_32=gather[32], gather_ms_4096=gather[4096],
                pull_ms_32=gather["pull_32_host_ms"], pull_ms_4096=gather["pull_4096_host_ms"],
                peak_gib=peak / 2 ** 30, left_gib=left / 2 ** 30)


def serve_batching(seed: int) -> dict:
    """Phase D: the continuous batcher at decode_batching_ab's full
    shapes, sessions joining as slots free; each session's tokens equal
    its solo ``speculative_generate`` run; batched against sequential
    tokens/s at each slot count."""
    tcfg = transformer.LMConfig(**BATCH_TCFG)
    dcfg = transformer.LMConfig(**BATCH_DCFG)
    tp = transformer.init_lm(seed, tcfg, SERVE_DEVICE)
    dp = transformer.init_lm(seed + 1, dcfg, SERVE_DEVICE)
    rows, batched_launches = [], 0
    for slots in BATCH_SLOTS:
        rng = np.random.default_rng(seed + slots)
        reqs = [DecodeRequest(prompt=rng.integers(0, tcfg.vocab, (1, BATCH_PROMPT)),
                              steps=BATCH_STEPS[i % len(BATCH_STEPS)])
                for i in range(BATCH_SESSIONS_A_SLOT * slots)]
        tokens = sum(int(r.steps) for r in reqs)
        b = ContinuousBatcher(tp, tcfg, dp, dcfg, BatcherConfig(
            slots=slots, max_prompt=BATCH_PROMPT, max_new=max(BATCH_STEPS), gamma=BATCH_GAMMA))
        with torch.no_grad():
            b.warmup()
            speculative.speculative_generate(tp, tcfg, dp, dcfg, reqs[0].prompt, 4,
                                             gamma=BATCH_GAMMA)
            torch.cuda.synchronize()
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            solo = [speculative.speculative_generate(tp, tcfg, dp, dcfg, r.prompt, r.steps,
                                                     gamma=BATCH_GAMMA).cpu().numpy()
                    for r in reqs]
            torch.cuda.synchronize()
            seq_s = time.perf_counter() - t0
            seq_launches = fa.flash_attention.launches
            handles, pending = [], list(reqs)
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            while pending or b.active_sessions():
                wave = []
                while pending and len(wave) < b.free_slots():
                    wave.append((pending.pop(0), None))
                if wave:
                    handles += b.admit_many(wave)
                b.step_block()
            torch.cuda.synchronize()
            bat_s = time.perf_counter() - t0
            bat_launches = fa.flash_attention.launches
        batched_launches += bat_launches
        apart = sum(not np.array_equal(h.out, s) for h, s in zip(handles, solo))
        check(apart == 0, f"serve batcher {slots} slots: {apart} of {len(reqs)} sessions differ "
              "from their solo runs")
        st = b.stats()
        rows.append(dict(slots=slots, sessions=len(reqs), tokens=tokens, seq_s=seq_s,
                         batched_s=bat_s, seq_tokens_per_s=tokens / seq_s,
                         batched_tokens_per_s=tokens / bat_s, ratio=seq_s / bat_s,
                         rounds=st["rounds"], accepted_frac=st["accepted_frac"],
                         batched_launches=bat_launches, seq_launches=seq_launches))
        del b
    return dict(rows=rows, flash_launches=batched_launches,
                target=BATCH_TCFG, draft=BATCH_DCFG, gamma=BATCH_GAMMA)


def serving_plane(seed: int, smi: str, gen) -> dict:
    """Phases A-D of the serving plane, printed as they finish, and
    ``flash_fwd`` held to its plain version at the two prefill shapes
    they launch it at."""
    flash_rows = [
        # the CLI's decode lane: 4 prompt rows x 4 heads of 16, width 64
        flash_case("serve CLI decode-lane prefill", gen, bh=16, sq=64, sk=64, d=16,
                   dtype=torch.float32),
        # a batcher join at phase D's widest wave: 16 rows x 8 heads of 64, prompt 8
        flash_case("serve batcher join", gen, bh=128, sq=8, sk=8, d=64, dtype=torch.float32),
    ]
    for r in flash_rows:
        print(f"# parity flash {r['case']} (BH {r['bh']}, S {r['sq']}, D {r['d']}, {r['dtype']}, "
              f"causal): out max |diff| {r['max_abs_err']:.3g}, lse {r['lse_err']:.3g} within "
              f"{r['tolerance']}; run-to-run bit-identical {r['deterministic']}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){f32_note(r)} [{smi}]", flush=True)
    t0 = time.perf_counter()
    cli = serve_cli_path(seed)
    for name, run in cli.items():
        pts = run["points"]
        co, rep = run["stats"]["coalescer"], run["stats"].get("replica")
        print(f"# serve CLI --replica {name} (2^22 slots via main(), card's own numbers, {smi}): "
              f"capacity {run['capacity']} req/s; "
              + "; ".join(f"{p['offered_rate']}/s offered: p50 {p['latency_ms']['p50_ms']} ms, p99 "
                          f"{p['latency_ms']['p99_ms']} ms, p99.9 {p['latency_ms']['p999_ms']} ms, "
                          f"shed {p['shed_frac']}, goodput {p['goodput_per_sec']}/s, completed "
                          f"{p['completed']} of {p['accepted']} admitted" for p in pts)
              + f"; coalescer submits/request {co['submits_per_request']}, key dedup "
              f"{co['key_dedup_factor']}; replica "
              + (f"age {rep['age_s']} s, {rep['nbytes']} B" if rep else "off")
              + f"; launches {run['launches']}; {run['wall_s']:.1f} s", flush=True)
        if run["decode"]:
            d = run["decode"][0]
            print(f"# serve decode lane (--batch-slots 8, {smi}): latency {d['value']} ms for "
                  f"{d['tokens_per_request']} tokens, accepted {d['accepted_frac']}, batcher "
                  f"{d['batcher']}", flush=True)
        print(f"# serve_frontend_stats {name}: {json.dumps(run['stats'])}", flush=True)
    t_a = time.perf_counter()
    par = serve_parity(seed)
    print(f"# serve card vs CPU (seed {seed}): table after the warm push bit-equal at 2^22 slots "
          f"({par['warm_keys']} distinct keys in {par['nonzero_slots']} nonzero slots); "
          f"values and predict scores of {par['requests']} requests bit-equal in modes "
          f"{par['modes']}", flush=True)
    t_b = time.perf_counter()
    big = serve_bigtable(seed)
    print(f"# serve device replica at 2^30 slots ({big['table_gib']:.0f} GiB f32, host budget "
          f"{big['host_budget_gib']:.0f} GiB; {smi}): host-mode refresh refused (MemoryError); "
          f"device mode served {big['served']} requests through {big['pushes']} in-place pushes, "
          f"replica version {big['replica_version']}, degraded 0; refresh (snapshot) "
          f"{['%.1f' % x for x in big['refresh_ms']]} ms (host clock); gather "
          f"{big['gather_ms_32']:.4f} ms at 32 keys, {big['gather_ms_4096']:.4f} ms at 4096 "
          f"(CUDA events); replica.pull {big['pull_ms_32']:.3f} / {big['pull_ms_4096']:.3f} ms "
          f"(host); peak device memory {big['peak_gib']:.2f} GiB, {big['left_gib']:.3f} GiB held "
          "after the phase", flush=True)
    t_c = time.perf_counter()
    bat = serve_batching(seed)
    for r in bat["rows"]:
        print(f"# serve batcher {r['slots']} slots ({r['sessions']} sessions, {r['tokens']} "
              f"tokens, {smi}): batched {r['batched_tokens_per_s']:.0f} tokens/s vs sequential "
              f"{r['seq_tokens_per_s']:.0f} ({r['ratio']:.2f}x); {r['rounds']} rounds, accepted "
              f"{r['accepted_frac']:.3f}; flash_fwd launches batched {r['batched_launches']}, "
              f"sequential {r['seq_launches']}; every session equal to its solo run", flush=True)
    print(f"# serve batcher phase: flash_fwd launches in the batched loops {bat['flash_launches']}",
          flush=True)
    t_d = time.perf_counter()
    return dict(cli=cli, parity=par, bigtable=big, batching=bat, flash_rows=flash_rows,
                seconds=dict(a=t_a - t0, b=t_b - t_a, c=t_c - t_b, d=t_d - t_c))


# -- phase 8b: telemetry on the card ------------------------------------------

#: a trace's kernel records, by the substring of the kernel's symbol
TRACE_KERNELS = dict(ftrl_dense="ftrl_dense_kernel", quantize="quantize_kernel",
                     segment_sum="segment_sum_f32", flash_fwd="flash_fwd_",
                     flash_bwd_dq="flash_bwd_dq_", flash_bwd_dkv="flash_bwd_dkv_")
ROOFLINE_MAX = 1.05  # a share over this is a wrong count, not a fast kernel
SAMPLE_EVERY = 8
OVERHEAD_PAIRS = 3
LM_DEFAULT = ["--steps", "5", "--report-every", "1", "--seed", "3", "--device", "cuda"]


def trace_kernels(log_dir: str) -> dict:
    """The newest capture's kernel records of each kernel of the port."""
    from parameter_server_tpu_torch.utils import profiling

    by_name = profiling.kernel_counts(log_dir)
    check(by_name, f"capture in {log_dir}: no CUDA kernel record (a failed capture)")
    return {k: sum(n for name, n in by_name.items() if sub in name)
            for k, sub in TRACE_KERNELS.items()}


def registry_values(name: str) -> dict:
    from parameter_server_tpu_torch.telemetry import registry as treg

    return treg.default_registry().snapshot().get(name, {}).get("values", {})


def telemetry_ctr(tmp: str, seed: int) -> dict:
    """(a) the CTR conf cut to one pass through the linear CLI, with
    ``--report-interval 1 --profile DIR`` and without: the same model
    bits, the capture's kernel records equal to the launch counters, the
    dashboard printed."""
    write_ctr_shards(os.path.join(tmp, "train"), CTR_SHARDS, CTR_ROWS, seed)
    runs = {}
    for name, extra in (("profiled", ["--report-interval", "1", "--profile",
                                      os.path.join(tmp, "prof")]), ("plain", [])):
        model = os.path.join(tmp, "model", name)
        path = os.path.join(tmp, f"{name}.conf")
        with open(path, "w") as f:
            f.write(ctr_conf(os.path.join(tmp, "train", "part.*"), model, num_data_pass=1))
        random.seed(seed)
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = linear_main.main([path] + extra, device="cuda")
        wall = time.perf_counter() - t0
        check(rc == 0, f"telemetry CTR {name}: the CLI exited {rc}")
        _, dense_n, quant_n, seg_n = counts()
        with open(model + "_S0", "rb") as f:
            runs[name] = dict(model=f.read(), out=buf.getvalue(), wall_s=wall,
                              launches=dict(ftrl_dense=dense_n, quantize=quant_n, segment_sum=seg_n))
    prof, plain = runs["profiled"], runs["plain"]
    check(prof["model"] == plain["model"], "telemetry CTR: --profile changed the model")
    check("node      total(s)" in prof["out"] and "telemetry:" in prof["out"],
          "telemetry CTR: no dashboard printed")
    traced = trace_kernels(os.path.join(tmp, "prof"))
    for k, n in prof["launches"].items():
        check(n > 0 and traced[k] == n, f"telemetry CTR: trace has {traced[k]} {k} records, "
              f"the counter {n}")
    return dict(launches=prof["launches"], traced={k: traced[k] for k in prof["launches"]},
                wall_s=dict(profiled=prof["wall_s"], plain=plain["wall_s"]),
                model_bytes=len(prof["model"]))


def telemetry_serve(seed: int) -> dict:
    """(b) the serve CLI at phase A's defaults with ``--replica full
    --decode --batch-slots 8 --expose-port 0``, scraped from a thread:
    every endpoint answers, the request counters equal the CLI's own
    record, and ``ps_device_hbm_bytes_in_use`` equals
    ``torch.cuda.memory_stats()`` read beside it."""
    from parameter_server_tpu_torch.telemetry import exposition
    from parameter_server_tpu_torch.telemetry import registry as treg
    import urllib.request

    servers, scrapes, errors = [], [], []
    real = exposition.expose_cluster

    def capture(*a, **k):
        srv = real(*a, **k)
        servers.append(srv)
        return srv

    def get(url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.read()

    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            if servers:
                try:
                    url = servers[0].url
                    t0 = time.perf_counter()
                    text = get(url + "/metrics").decode()
                    ms = (time.perf_counter() - t0) * 1e3
                    after = torch.cuda.memory_stats()["allocated_bytes.all.current"]
                    health = json.loads(get(url + "/healthz"))
                    snap = json.loads(get(url + "/debug/snapshot"))
                    scrapes.append(dict(ms=ms, text=text, health=health, snap_keys=sorted(snap),
                                        after=after))
                except Exception as e:  # the server closes at the end of the run
                    errors.append(repr(e))
            stop.wait(0.25)

    exposition.expose_cluster = capture
    thread = threading.Thread(target=scrape, name="smoke-scraper", daemon=True)
    thread.start()
    reset_counts()
    try:
        recs = run_serve_cli(["--num-slots", str(SERVE_SLOTS), "--seed", str(seed), "--device",
                              "cuda", "--replica", "full", "--decode", "--batch-slots", "8",
                              "--expose-port", "0"])
    finally:
        stop.set()
        thread.join(timeout=30)
        exposition.expose_cluster = real
    check(len(scrapes) >= 3, f"telemetry serve: {len(scrapes)} scrapes ({errors[:3]})")
    last = scrapes[-1]
    check('ps_serve_requests_total{' in last["text"] and "ps_device_hbm_bytes_in_use{" in last["text"],
          "telemetry serve: /metrics lacks ps_serve_requests_total or the device family")
    check("dead_nodes" in last["health"] and {"metrics", "cluster", "health"} <= set(last["snap_keys"]),
          "telemetry serve: /healthz or /debug/snapshot incomplete")
    by = {r["metric"]: r for r in recs}
    stats = by["serve_frontend_stats"]
    requests = sum(registry_values("ps_serve_requests_total").values())
    # the 10 + 200 closed-loop calibration requests, then the measured frontend's
    check(requests == 210 + stats["completed"],
          f"telemetry serve: ps_serve_requests_total {requests}, the CLI's record "
          f"210 + {stats['completed']}")
    check(by["serve_exposition"]["healthz_ok"] is not None, "telemetry serve: no exposition record")
    # the memory gauge against the allocator, read beside it with nothing running
    torch.cuda.synchronize()
    treg.default_registry().render_text()
    beside = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    gauge = registry_values("ps_device_hbm_bytes_in_use")
    check(gauge.get("device=cuda:0") == beside,
          f"telemetry serve: ps_device_hbm_bytes_in_use {gauge}, memory_stats {beside}")
    scraped = []
    for sc in scrapes:
        for line in sc["text"].splitlines():
            if line.startswith("ps_device_hbm_bytes_in_use{") and 'device="cuda:0"' in line:
                scraped.append(abs(float(line.rsplit(" ", 1)[1]) - sc["after"]))
    ms = sorted(sc["ms"] for sc in scrapes)
    return dict(scrapes=len(scrapes), scrape_errors=len(errors), requests=requests,
                completed=stats["completed"], hbm_bytes=beside,
                scrape_ms_median=ms[len(ms) // 2], scrape_ms_max=ms[-1],
                scraped_hbm_gap_max=max(scraped) if scraped else None,
                launches=dict(flash_fwd=fa.flash_attention.launches,
                              segment_sum=seg.segment_sum.launches))


def telemetry_lm() -> dict:
    """(c) the LM CLI at its defaults (2 layers, float32) for 5 steps with
    and without ``--profile``: bit-equal losses, the capture's flash
    records equal to the counters."""
    from parameter_server_tpu_torch.telemetry import device as device_tel

    real = device_tel.instrument
    out = {}
    with tempfile.TemporaryDirectory(prefix="lm_prof_") as tmp:
        for name, extra in (("profiled", ["--profile", tmp]), ("plain", [])):
            losses = []

            def recording(fn_name, fn, *a, **k):
                def step(*args):
                    p, o, loss = fn(*args)
                    losses.append(loss.item())  # exact: the step's own float
                    return p, o, loss
                return real(fn_name, step, *a, **k)

            device_tel.instrument = recording
            reset_counts()
            try:
                _, recs = run_lm_cli_records(LM_DEFAULT + extra)
            finally:
                device_tel.instrument = real
            out[name] = dict(losses=losses, logged=[r["loss"] for r in recs], launches=dict(
                flash_fwd=fa.flash_attention.launches, flash_bwd_dq=fa.flash_bwd_dq.launches,
                flash_bwd_dkv=fa.flash_bwd_dkv.launches))
        traced = trace_kernels(tmp)
    prof, plain = out["profiled"], out["plain"]
    check(len(prof["losses"]) == 5 and prof["losses"] == plain["losses"],
          f"telemetry LM: losses with --profile {prof['losses']}, without {plain['losses']}")
    for k, n in prof["launches"].items():
        check(n > 0 and traced[k] == n, f"telemetry LM: trace has {traced[k]} {k} records, "
              f"the counter {n}")
    return dict(losses=prof["losses"], launches=prof["launches"],
                traced={k: traced[k] for k in prof["launches"]})


def telemetry_inventory(batches) -> dict:
    """(d) the device inventory with every 8th call sampled over the
    headline step: roofline gauges present, no share over ROOFLINE_MAX,
    no new signature after warm-up, no dispatch fallback."""
    from parameter_server_tpu_torch.system.postoffice import Postoffice
    from parameter_server_tpu_torch.telemetry import device as device_tel
    from parameter_server_tpu_torch.telemetry import registry as treg

    Postoffice.reset()  # a fresh registry and inventory
    device_tel.install_hbm_monitor()
    prev = device_tel.set_sampling(SAMPLE_EVERY)
    try:
        worker = AsyncSGDWorker(conf("sparse"), device="cuda")
        worker.train(batches[:T], pipelined=True)
        device_tel.mark_warmup()
        for _ in range(2):
            worker.train(batches[T:], pipelined=True)
        torch.cuda.synchronize()
        treg.default_registry().render_text()  # folds the finished samples
        snap = device_tel.snapshot()
    finally:
        device_tel.set_sampling(prev)
    fracs = registry_values("ps_device_roofline_frac")
    gb_s = registry_values("ps_device_kernel_gb_s")
    recompiles = sum(registry_values("ps_device_recompiles_total").values())
    fallbacks = sum(registry_values("ps_device_dispatch_fallbacks_total").values())
    check(fracs and gb_s, f"telemetry inventory: no roofline gauge ({snap['functions']})")
    check(max(fracs.values(), default=0.0) <= ROOFLINE_MAX,
          f"telemetry inventory: a roofline share over {ROOFLINE_MAX}: {fracs}")
    check(recompiles == 0 and snap["recompiles_post_warmup"] == 0,
          f"telemetry inventory: {recompiles} recompiles after warm-up ({snap['functions']})")
    check(fallbacks == 0, f"telemetry inventory: {fallbacks} dispatch fallbacks")
    return dict(functions=snap["functions"], roofline_frac=fracs, kernel_gb_s=gb_s,
                recompiles=recompiles, dispatch_fallbacks=fallbacks,
                device_kind=snap.get("device_kind"))


def telemetry_overhead(batches) -> dict:
    """(e) the pipelined headline with telemetry on and off, three pairs
    in turns (on/off, off/on, on/off), and beside each pair the same with
    telemetry on but the learning plane's key heat never noted (its share
    of the cost): a warm-up launch, then the timed launches; each worker
    built after the switch, as every instrument decides at construction."""
    from parameter_server_tpu_torch.telemetry import registry as treg

    rates = dict(on=[], off=[], on_no_heat=[])
    prev = treg.enabled()
    try:
        for pair in range(OVERHEAD_PAIRS):
            order = ("on", "off", "on_no_heat") if pair % 2 == 0 else ("on_no_heat", "off", "on")
            for state in order:
                treg.set_enabled(state != "off")
                worker = AsyncSGDWorker(conf("sparse"), device="cuda")
                if state == "on_no_heat":
                    worker._learning.heat_every = 1 << 62
                worker.train(batches[:T], pipelined=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                worker.train(batches[T:T * (PIPE_LAUNCHES + 1)], pipelined=True)
                torch.cuda.synchronize()
                rates[state].append(PIPE_LAUNCHES * T * MB / (time.perf_counter() - t0))
                worker.executor.stop()
    finally:
        treg.set_enabled(prev)
    med = {k: float(np.median(v)) for k, v in rates.items()}
    return dict(examples_per_s=rates, median=med, overhead=1.0 - med["on"] / med["off"],
                overhead_no_heat=1.0 - med["on_no_heat"] / med["off"])


def telemetry_plane(seed: int, smi: str, batches) -> dict:
    """Phase 8b, (a)-(e), printed as they finish."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tel_ctr_") as tmp:
        ctr = telemetry_ctr(tmp, seed + 21)
    print(f"# telemetry (a) CTR conf, one pass via the CLI ({smi}): --report-interval 1 "
          f"--profile and plain, model bits equal; launches {ctr['launches']}, capture's kernel "
          f"records {ctr['traced']}; dashboard printed; wall {ctr['wall_s']}", flush=True)
    srv = telemetry_serve(seed)
    print(f"# telemetry (b) serve CLI --expose-port 0 ({smi}): {srv['scrapes']} scrapes of "
          f"/metrics, /healthz, /debug/snapshot during the run; /metrics scrape median "
          f"{srv['scrape_ms_median']:.2f} ms, max {srv['scrape_ms_max']:.2f} ms (host clock); "
          f"ps_serve_requests_total {srv['requests']} = 210 calibration + {srv['completed']} "
          f"completed; ps_device_hbm_bytes_in_use {srv['hbm_bytes']} = memory_stats (scrapes vs "
          f"memory_stats read just after: at most {srv['scraped_hbm_gap_max']} B apart); "
          f"launches {srv['launches']}", flush=True)
    lmr = telemetry_lm()
    print(f"# telemetry (c) LM CLI defaults, 5 steps, float32 ({smi}): losses with and without "
          f"--profile bit-equal {lmr['losses']}; launches {lmr['launches']}, capture's records "
          f"{lmr['traced']}", flush=True)
    inv = telemetry_inventory(batches)
    print(f"# telemetry (d) device inventory, every {SAMPLE_EVERY}th call sampled, headline "
          f"pipelined ({smi}, {inv['device_kind']}): roofline shares "
          f"{ {k: round(v, 5) for k, v in inv['roofline_frac'].items()} } (max {ROOFLINE_MAX}), "
          f"GB/s {({k: round(v, 2) for k, v in inv['kernel_gb_s'].items()})}; recompiles after "
          f"warm-up {inv['recompiles']}, dispatch fallbacks {inv['dispatch_fallbacks']}",
          flush=True)
    ovh = telemetry_overhead(batches)
    print(f"# telemetry (e) pipelined headline, telemetry on / off, {OVERHEAD_PAIRS} pairs in "
          f"turns ({smi}): ex/s on {['%.0f' % x for x in ovh['examples_per_s']['on']]}, off "
          f"{['%.0f' % x for x in ovh['examples_per_s']['off']]}, on without the key heat "
          f"{['%.0f' % x for x in ovh['examples_per_s']['on_no_heat']]}; medians "
          f"{ovh['median']['on']:.0f} / {ovh['median']['off']:.0f} / "
          f"{ovh['median']['on_no_heat']:.0f} (overhead {100 * ovh['overhead']:.2f}%, "
          f"{100 * ovh['overhead_no_heat']:.2f}% without the key heat)", flush=True)
    return dict(ctr=ctr, serve=srv, lm=lmr, inventory=inv, overhead=ovh,
                seconds=time.perf_counter() - t0)


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
    clock_hz = max_sm_clock_hz()
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
    keep_ok = interior_keep(rel.numel(), ok, gen)
    g_kept = torch.where(keep_ok, g_u, 0.0)  # the KKT step zeroes a suppressed gradient
    rel_b, ok_b, g_b = bigtable_update_inputs(args.seed + 1_000_000, gen)
    keep_b = interior_keep(rel_b.numel(), ok_b, gen)
    sparse_rows = [
        sparse_case(torch.float32, None, rel, ok, g_u, gen),
        sparse_case(torch.bfloat16, 7, rel, ok, g_u, gen),
        sparse_case(torch.float32, None, rel, keep_ok, g_kept, gen, label=" interior keep"),
        sparse_case(torch.bfloat16, 7, rel, keep_ok, g_kept, gen, label=" interior keep"),
        sparse_case(torch.bfloat16, 7, rel_b, keep_b, torch.where(keep_b, g_b, 0.0), gen, p=1 << 30,
                    label=" interior keep"),
    ]
    del rel_b, ok_b, g_b, keep_b
    torch.cuda.empty_cache()
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
        print_segment_row(r, smi)

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
    kkt = kkt_path(batches)
    kc = kkt["counts"]
    print(f"# KKT (card's own numbers, {smi}): headline sparse 2^22, T={T}, escape {kkt['escape']:g}; "
          f"first ministep counts {kkt['first_ministep_counts']['suppressed']} of "
          f"{kkt['first_ministep_counts']['candidates']} and state bits equal to the CPU's; "
          f"{kkt['ministeps']} ministeps: candidates {kc['candidates']}, suppressed {kc['suppressed']} "
          f"({kc['suppressed'] / kc['candidates']:.4f}; the CPU run {kkt['cpu_counts']['suppressed']}, "
          f"{kkt['suppressed_gap']} apart, tolerance {KKT_COUNT_TOL:g} of the candidates); slots of the "
          f"state beyond the card-vs-CPU tolerance {kkt['slots_apart']} (bound {KKT_STATE_TOL:g} of "
          f"{SLOTS}; bits all equal: {kkt['state_bits_equal_cpu']}); escape 1 "
          f"bit-identical to no filter; drop set (drop after 2, revisit every 5, 10 ministeps): "
          f"{kkt['drop']}, {kkt['drop_ms_per_ministep']:.3f} ms a ministep, of which the keep "
          f"vector's and slot ids' copy to the host {kkt['feedback_copy_ms_per_ministep']:.3f} ms and "
          f"the drop tracker {kkt['feedback_track_ms_per_ministep']:.3f} ms (host clock); sparse "
          f"launches {kkt['sparse_launches']}", flush=True)
    enc = encoded_path(batches)
    er, ee = enc["raw"], enc["exact"]
    print(f"# encoded exact wire (card's own numbers, {smi}): pipelined headline, 2 x {ENC_LAUNCHES} "
          f"launches of T={T}, raw / exact + cache 64 MB: {er['examples_per_s']:.0f} / "
          f"{ee['examples_per_s']:.0f} ex/s wall-clock; bytes copied to the card "
          f"{er['uploaded_bytes_per_example']:.1f} / {ee['uploaded_bytes_per_example']:.1f} a example "
          f"(a batch: {enc['raw_batch_bytes_per_example']:.1f} / "
          f"{enc['encoded_batch_bytes_per_example']:.1f}); cache hit share {ee['cache_hit_share']:.3f}; "
          f"host encode {ee['encode_ms_per_ministep']:.3f} ms a ministep (summed over workers); state "
          f"bits identical", flush=True)
    bw = bits_paths(batches)
    print(f"# bits wire (card's own numbers, {smi}): dense 2^22, ell_lanes 39, tau 4, T={T}: "
          f"{bw['examples_per_s']:.0f} ex/s pipelined, {bw['uploaded_bytes_per_example']:.1f} bytes "
          f"copied a example; launches dense {bw['dense_launches']}, segment_sum "
          f"{bw['segment_launches']}; decoded batch equal to the raw one; T=8, tau 0 state bits "
          f"identical to the hashed path", flush=True)
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
        tau = tau_path(tmp, args.seed + 5)
        stream = stream_path(tmp, args.seed + 2)
        evals = eval_path(tmp, args.seed, dict(
            ctr=os.path.join(tmp, "model", "ctr_online.*"),
            criteo=os.path.join(tmp, "criteo_native_S*")),
            dict(ctr=ctr["model_nonzeros"], criteo=crit["model_nonzeros"]))
        big = bigtable_path(tmp, args.seed + 2)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="darlin_smoke_") as tmp:
        dar = darlin_path(tmp, args.seed + 11, lat["ns_per_add"])
    torch.cuda.empty_cache()
    for name, d in (("Criteo", dar["criteo"]), ("CTR", dar["ctr"])):
        conf = f"configs/{name.lower()}/batch_l1lr.conf"
        print(f"# darlin {name} ({conf} via CLI, card's own numbers, {smi}): {d['rows']} rows, "
              f"{d['entries']} entries, {d['columns']} columns, {d['blocks']} blocks, {d['passes']} "
              f"passes ({d['block_steps']} block steps); objective {d['objective_first']:.6e} -> "
              f"{d['objective_last']:.6e}; nnz(w) {d['nnz_w']}, active {d['active']}, violation "
              f"{d['violation']:.3g}; max_dispatch_window {d['max_dispatch_window']} (in flight on "
              f"the card at a submit, at most {d['max_in_flight_observed']}); wall {d['wall_s']:.2f} s: "
              f"load + localize {d['load_s']:.2f} s, init_data (upload) {d['init_s']:.2f} s, passes "
              f"{d['passes_s']:.2f} s; {d['block_steps_per_s']:.1f} block steps/s; segment_sum "
              f"launches {d['segment_launches']} (3 a block step); eval_batch.conf on "
              f"{d['eval']['rows']} held-out rows: auc {d['eval']['auc']:.6f}, logloss "
              f"{d['eval']['logloss']:.6f} ({d['eval']['wall_s']:.2f} s, segment_sum launches "
              f"{d['eval']['segment_launches']})", flush=True)
    d = dar["criteo"]
    print(f"# darlin Criteo block step (CUDA events, cold L2, final state, {smi}): median "
          f"{d['median_block_ms']:.4f} ms, slowest {d['max_block_ms']:.4f} ms, the {d['blocks']} "
          f"blocks' sum (a pass's device time) {d['pass_device_ms']:.3f} ms against a pass's wall "
          f"{d['passes_s'] / d['passes'] * 1e3:.3f} ms; a step: {d['aten_ops_a_step']} aten ops, "
          f"{d['segment_launches_a_step']} segment_sum launches (two sums by column, one by row; "
          f"parity rows below); evaluate() {d['evaluate_ms']:.1f} ms a pass (host clock); peak "
          f"device memory above what earlier phases hold "
          f"{d['peak_gib']:.3f} GiB; data written in {dar['criteo_write_s']:.1f} s", flush=True)
    for r in d["segment_rows"]:
        print_segment_row(r, smi)
    seg_rows += d["segment_rows"]
    g = dar["agree"]
    print(f"# darlin card vs CPU (the Criteo batch conf on {g['rows']} rows, {smi}): {g['passes']} "
          f"passes on both; objectives {g['objective_rel_gap']:.3g} apart (bar {DARLIN_OBJ_RTOL}); "
          f"counts apart {g['counts_apart']} (bar {g['count_bound']:.0f} = {DARLIN_COUNT_TOL} of "
          f"{g['columns']} columns); weights of common keys max |diff| {g['max_abs_weight_diff']:.3g}; "
          f"two card runs: w, the dual and every progress line bit-identical; passes card "
          f"{g['card_passes_s']:.2f} s, CPU {g['cpu_passes_s']:.2f} s", flush=True)
    print(f"# adaptive tau (CTR conf via CLI, card's own numbers, {smi}): {tau['ministeps']} ministeps, "
          f"tau trajectory {tau['tau_trace']} equal to the CPU run's; episodes {tau['episodes']}; "
          f"{tau['examples_per_s_e2e']:.0f} ex/s end to end, step {tau['step_ms_per_ministep']:.3f} ms; "
          f"objective {tau['objective_first']:.5f} -> {tau['objective_last']:.5f}", flush=True)
    print(f"# stream wire (Criteo data via CLI, card's own numbers, {smi}): {stream['ministeps']} "
          f"ministeps, {stream['dict_lanes']} dictionary lanes of 39 (codes {stream['code_bits']} bits, "
          f"raw {stream['raw_bits']}), {stream['stream_batch_bytes_per_example']:.1f} bytes a example; "
          f"prep {stream['prep_ms_per_ministep']:.3f} ms, upload {stream['upload_ms_per_ministep']:.3f} "
          f"ms, step {stream['step_ms_per_ministep']:.3f} ms a ministep; {stream['examples_per_s_e2e']:.0f} "
          f"ex/s end to end; state bits identical to the hashed path", flush=True)
    print(f"# bigtable conf via CLI (card's own numbers, {smi}): 2^{big['num_slots'].bit_length() - 1} "
          f"slots, bf16 sqrt_n, T=8, tau 4, {big['ministeps']} ministeps of 16384 rows: "
          f"{big['examples_per_s_e2e']:.0f} ex/s end to end ({big['wall_s']:.1f} s); per ministep: parse "
          f"{big['parse_ms_per_ministep']:.3f} ms, tail filter {big['filter_ms_per_ministep']:.3f} ms, prep "
          f"{big['prep_ms_per_ministep']:.3f} ms, upload {big['upload_ms_per_ministep']:.3f} ms, step "
          f"{big['step_ms_per_ministep']:.3f} ms; peak device memory {big['peak_gib']:.2f} GiB; objective "
          f"{big['objective_first']:.5f} -> {big['objective_last']:.5f}; model nonzeros "
          f"{big['model_nonzeros']}; sparse launches {big['sparse_launches']}", flush=True)
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
        flash_case("float32 GQA 4", gen, dtype=torch.float32, group=4),
        flash_case("float32 D=128 window 1024", gen, d=128, dtype=torch.float32, window=1024),
        flash_case("float32 offsets, Sq != Sk, ragged Sk tail", gen, sq=1000, sk=2037, q_off=1037,
                   dtype=torch.float32),
        flash_case("float32 D=32", gen, d=32, dtype=torch.float32),
        flash_case("float32 S 8192", gen, bh=8, sq=8192, sk=8192, dtype=torch.float32),
    ]
    for r in flash_rows:
        print(f"# parity flash {r['case']} (BH {r['bh']}, Sq {r['sq']}, Sk {r['sk']}, D {r['d']}, "
              f"{r['dtype']}, window {r['window']}, offsets {r['q_off']}/{r['k_off']}, group "
              f"{r['group']}): out max |diff| {r['max_abs_err']:.3g}, lse {r['lse_err']:.3g} within "
              f"{r['tolerance']}; run-to-run bit-identical {r['deterministic']}; kernel "
              f"{r['ms']:.4f} ms ({r['tflop_per_s']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['flop']:.4g} FLOP, {r['bytes']} B), MUFU floor "
              f"{mufu_floor_ms(r['pairs'], clock_hz):.4f} ms at {clock_hz / 1e6:.0f} MHz{f32_note(r)} "
              f"[{smi}]", flush=True)
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
        flash_bwd_case("float32 GQA 4", gen, sq=2048, sk=2048, dtype=torch.float32, group=4),
        flash_bwd_case("float32 D=128 window 1024", gen, sq=2048, sk=2048, d=128,
                       dtype=torch.float32, window=1024),
        flash_bwd_case("float32 offsets, Sq != Sk, ragged Sk tail, dlse", gen, sq=1000, sk=2037,
                       q_off=1037, dtype=torch.float32, dlse=True),
        flash_bwd_case("float32 D=16 LM CLI default", gen, bh=32, sq=256, sk=256, d=16,
                       dtype=torch.float32),
        flash_bwd_case("float32 D=32 window 300 GQA 2", gen, sq=1024, sk=1024, d=32,
                       dtype=torch.float32, window=300, group=2),
        flash_bwd_case("float32 S 8192", gen, bh=4, dtype=torch.float32),
    ]
    for r in bwd_rows:
        print(f"# parity flash bwd {r['case']} (B*H {r['bh']}, Sq {r['sq']}, Sk {r['sk']}, D {r['d']}, "
              f"{r['dtype']}, window {r['window']}, offsets {r['q_off']}/{r['k_off']}, group "
              f"{r['group']}, dlse {r['dlse']}): max |diff| {r['max_abs_err']} within "
              f"{r['tolerance']}; two backward passes bit-identical {r['deterministic']}", flush=True)
    bwd_f32_rows = [r for r in bwd_rows if r["dtype"] == "float32"]
    print(f"# flash_bwd float32, {len(bwd_f32_rows)} cases: largest tolerance_used " + ", ".join(
        f"{g} {max(r['readings'][g]['tolerance_used'] for r in bwd_f32_rows):.4g}"
        for g in ("dq", "dk", "dv")) + f" (tolerance {FLASH_BWD_TOL[torch.float32]}: rtol, atol as "
          f"a share of each gradient's largest |plain|); every case bit-identical run to run "
          f"{all(r['deterministic'] for r in bwd_f32_rows)}", flush=True)
    mma_rate = flash_ab.tf32_mma_tflop_per_s(kernels.library("flash_fwd"), 20)
    print(f"# mma.sync m16n8k8 TF32 alone: {mma_rate:.1f} TFLOP/s [{smi}]", flush=True)
    bwd_t = flash_bwd_times(gen)
    # the LM CLI's float32 training runs the f32 pair: heads of 64 at S 2048,
    # its default (B*H 32 x S 256 x D 16), and D 128
    bwd_f32 = {
        "S2048": flash_bwd_times(gen, bh=64, s=2048, dtype=torch.float32, plain_chunk=16,
                                 mma_tflop_per_s=mma_rate),
        "cli_default": flash_bwd_times(gen, bh=32, s=256, d=16, dtype=torch.float32,
                                       plain_chunk=32, mma_tflop_per_s=mma_rate),
        "D128": flash_bwd_times(gen, bh=64, s=2048, d=128, dtype=torch.float32, plain_chunk=16,
                                mma_tflop_per_s=mma_rate),
    }
    for t in (bwd_t, *bwd_f32.values()):
        print(f"# time flash bwd (B*H {t['bh']}, S {t['s']}, D {t['d']}, {t['dtype']}, causal): "
              f"flash_bwd_dq {t['dq_ms']:.4f} ms ({t['dq_tflop_per_s']:.1f} TFLOP/s, bound "
              f"{t['dq_bound_ms']:.4f} ms {t['dq_bound_by']}), flash_bwd_dkv {t['dkv_ms']:.4f} "
              f"ms ({t['dkv_tflop_per_s']:.1f} TFLOP/s, bound {t['dkv_bound_ms']:.4f} ms "
              f"{t['dkv_bound_by']}); the gradients' least work {t['both_bound_ms']:.4f} ms; "
              + (f"3xTF32 at mma.sync's rate dq {t['dq_mma_floor_ms']:.4f} ms, dkv "
                 f"{t['dkv_mma_floor_ms']:.4f} ms; " if "dq_mma_floor_ms" in t else "")
              + f"plain "
              f"backward {t['plain_ms']:.4f} ms; SDPA backward {t['sdpa_bwd_ms']:.4f} ms (the pair "
              f"{(t['dq_ms'] + t['dkv_ms']) / t['sdpa_bwd_ms']:.2f}x it); flash_fwd "
              f"{t['fwd_ms']:.4f} ms (bound {t['fwd_bound_ms']:.4f} ms {t['fwd_bound_by']}, "
              f"MUFU floor {mufu_floor_ms(t['pairs'], clock_hz):.4f} ms at {clock_hz / 1e6:.0f} MHz), "
              f"SDPA forward {t['sdpa_fwd_ms']:.4f} ms [{smi}]", flush=True)
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
    fam = lm_family(args.seed)
    moe, beam, turns, fcli = fam["moe_serving"], fam["beam"], fam["continuation"], fam["cli"]
    print(f"# LM family, MoE serving (card's own numbers, {smi}): the serving config with every "
          f"second layer 8 experts (capacity factor 8), B {moe['batch']}, prompt {moe['prompt']}, "
          f"{moe['steps']} steps: time to first token {moe['ttft_ms']:.1f} ms, decode "
          f"{moe['decode_tokens_per_s']:.0f} tokens/s, whole call {moe['generate_s']:.2f} s; flash "
          f"launches {moe['prefill_flash_launches']} a prefill; prefill logits vs the training "
          f"forward {moe['prefill_vs_forward_gap']:.4g} (tolerance {moe['tolerance']:.4g}); "
          f"flash_fwd on the prefill's inputs vs plain {moe['flash_held']}", flush=True)
    print(f"# LM family, beam search (card's own numbers, {smi}): width {beam['width']}, B "
          f"{beam['batch']}, prompt {beam['prompt']}, {beam['steps']} steps: "
          f"{beam['tokens_per_s']:.0f} sequences x steps/s ({beam['long_s']:.3f} s less the 1-step "
          f"call's {beam['short_s']:.3f} s, noisy {beam['diff_noisy']}); best scores vs teacher "
          f"forcing: each term within {beam['teacher_forced_term_gap']:.4g} (tolerance "
          f"{beam['tolerance']:.4g}), the sums {beam['teacher_forced_gap']:.4g} apart; the same "
          f"tokens in the runner-up's context {beam['runner_up_context_gap']:.4g} apart at worst; "
          f"width 1 equals greedy over {beam['width_one_is_greedy_steps']} steps; flash_fwd on the "
          f"prefill's inputs vs plain {beam['flash_held']}", flush=True)
    print(f"# LM family, continuation (card's own numbers, {smi}): turn 2 ({turns['turn_tokens']} "
          f"tokens + {turns['steps']} steps) {turns['turn2_s'] * 1e3:.1f} ms, ingest-only "
          f"{turns['ingest_only_s'] * 1e3:.1f} ms, turn 3 {turns['turn3_s'] * 1e3:.1f} ms; flash "
          f"launches first turn {turns['first_turn_flash_launches']}, later "
          f"{turns['later_flash_launches']}; vs single shot {turns['agreement']}; flash_fwd on the "
          f"first turn's inputs vs plain {turns['flash_held']}", flush=True)
    print(f"# LM family, CLI (card's own numbers, {smi}): full config with --moe-every 2, "
          f"{CLI_MOE_STEPS} Adam steps + a beam of 4: losses {fcli['moe']['losses']}, "
          f"{fcli['moe']['step_ms']:.1f} ms a step, peak {fcli['moe']['peak_gib']:.2f} GiB, "
          f"launches flash_fwd / dq / dkv {fcli['moe']['launches']}, the backward pair on its "
          f"inputs vs plain {fcli['moe']['flash_bwd_held']}; CLI_SMALL card vs CPU "
          + ", ".join(f"{k} {v['gap']:.3g}" for k, v in fcli["optimizers"].items())
          + f" (tolerance {CLI_LOSS_TOL}; Adafactor factored "
          f"{fcli['optimizers']['adafactor']['factored_leaves']} leaves of the width it ran); resumed "
          f"steps 6-10 card {fcli['resumed']['card']} vs CPU {fcli['resumed']['cpu']}, "
          f"{fcli['resume_gap']:.3g} apart", flush=True)
    serve = serving_plane(args.seed, smi, gen)
    flash_rows += serve["flash_rows"]
    tel = telemetry_plane(args.seed, smi, batches)
    f32_rows = [r for r in flash_rows if r["dtype"] == "float32"]
    print(f"# flash_fwd float32, {len(f32_rows)} cases: largest tolerance_used out "
          f"{max(r['readings']['tolerance_used'] for r in f32_rows):.4g}, lse "
          f"{max(r['lse_readings']['tolerance_used'] for r in f32_rows):.4g} (tolerance "
          f"{FLASH_TOL[torch.float32]}); every case bit-identical run to run "
          f"{all(r['deterministic'] for r in f32_rows)}", flush=True)
    f32_by_case = {r["case"]: r for r in f32_rows}
    f32_record = {
        name: {key: f32_by_case[case][key] for key in
               ("bh", "sq", "sk", "d", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for name, case in (("prefill", "float32"), ("batcher_join", "serve batcher join"),
                           ("decode_lane_prefill", "serve CLI decode-lane prefill"))}

    def bwd_f32_record(kernel: str) -> dict:
        """The f32 route: its launches in the LM CLI's float32 run and its
        times at each shape timed."""
        small = cli["small_launches"][1 if kernel == "dq" else 2]
        return dict(launches=small, **{name: dict(
            bh=t["bh"], s=t["s"], d=t["d"], ms=t[f"{kernel}_ms"], plain_ms=t["plain_ms"],
            library_ms=t["sdpa_bwd_ms"], bound_ms=t[f"{kernel}_bound_ms"],
            bound_by=t[f"{kernel}_bound_by"], mma_sync_floor_ms=t[f"{kernel}_mma_floor_ms"])
            for name, t in bwd_f32.items()})

    main_dense = ctr_dense  # f32 with an explicit mask: what the CTR step runs
    main_sparse = sparse_rows[0]
    main_quant = quant_times[0]  # the conf's 1-byte push: the whole quantize call
    # the CTR step's shard gradient by slot, the case this entry has always
    # timed (the darlin block sums, slower, print as parity rows of their own)
    main_seg = seg_rows[3]
    kernel_line = {"kernels": [
        dict(name="ftrl_sparse_kernel", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/ftrl_sparse.cu",
             replaces="parameter_server_tpu/ops/ftrl_sparse.py:407",
             launches=head["sparse_launches"],
             kkt_launches=kkt["sparse_launches"], bigtable_launches=big["sparse_launches"],
             interior_keep_cases=[r["case"] for r in sparse_rows if "interior" in r["case"]],
             max_abs_err=max(r["max_abs_err"] for r in sparse_rows),
             ms=main_sparse["ms"], plain_ms=main_sparse["plain_ms"],
             bound_ms=main_sparse["bound_ms"], bound_by=main_sparse["bound_by"],
             library_ms=None),
        dict(name="ftrl_dense_kernel", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/ftrl_dense.cu",
             replaces="parameter_server_tpu/ops/ftrl.py:265",
             launches=ctr["dense_launches"],
             bits_launches=bw["dense_launches"], stream_launches=stream["dense_launches"],
             tau_adaptive_launches=tau["dense_launches"],
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
             ell_scatter_launches=dict(bits=bw["segment_launches"], stream=stream["segment_launches"]),
             darlin_launches=dict(criteo_batch=dar["criteo"]["segment_launches"],
                                  ctr_batch=dar["ctr"]["segment_launches"]),
             serve_push_launches={name: run["launches"]["segment_sum"]
                                  for name, run in serve["cli"].items()},
             max_abs_err=max(r["max_abs_err"] for r in seg_rows),
             ms=main_seg["ms"], plain_ms=main_seg["plain_ms"],
             bound_ms=main_seg["bound_ms"], bound_by=main_seg["bound_by"],
             library_ms=main_seg["library_ms"]),
        dict(name="flash_fwd", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/flash_fwd.cu",
             replaces="parameter_server_tpu/ops/flash_attention.py:383",
             launches=lm["flash_launches"],
             serve_launches=dict(cli_decode_lane=serve["cli"]["full"]["launches"]["flash_fwd"],
                                 batcher=serve["batching"]["flash_launches"]),
             lm_family_launches=dict(moe_prefill=moe["prefill_flash_launches"],
                                     moe_generate=moe["flash_launches"],
                                     beam=beam["flash_launches"],
                                     first_turn=turns["first_turn_flash_launches"],
                                     moe_cli=fcli["moe"]["launches"][0],
                                     adafactor_cli=fcli["optimizers"]["adafactor"]["launches"][0],
                                     lion_cli=fcli["optimizers"]["lion"]["launches"][0]),
             max_abs_err=max(r["max_abs_err"] for r in flash_rows),
             tolerance={r["dtype"]: r["tolerance"] for r in flash_rows},
             ms=flash_rows[0]["ms"], plain_ms=flash_rows[0]["plain_ms"],
             bound_ms=flash_rows[0]["bound_ms"], bound_by=flash_rows[0]["bound_by"],
             library_ms=flash_rows[0]["library_ms"], f32=f32_record),
        dict(name="flash_bwd_dq", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/flash_bwd.cu",
             replaces="parameter_server_tpu/ops/flash_attention.py:430",
             launches=train["flash_bwd_dq_launches"],
             lm_family_launches=dict(moe_cli=fcli["moe"]["launches"][1],
                                     adafactor_cli=fcli["optimizers"]["adafactor"]["launches"][1],
                                     lion_cli=fcli["optimizers"]["lion"]["launches"][1]),
             max_abs_err=max(r["max_abs_err"]["dq"] for r in bwd_rows),
             tolerance={r["dtype"]: r["tolerance"] for r in bwd_rows},
             ms=bwd_t["dq_ms"], plain_ms=bwd_t["plain_ms"], bound_ms=bwd_t["dq_bound_ms"],
             bound_by=bwd_t["dq_bound_by"], library_ms=bwd_t["sdpa_bwd_ms"],
             f32=bwd_f32_record("dq")),
        dict(name="flash_bwd_dkv", route="cuda",
             source="parameter_server_tpu_torch/kernels/csrc/flash_bwd.cu",
             replaces="parameter_server_tpu/ops/flash_attention.py:430",
             launches=train["flash_bwd_dkv_launches"],
             lm_family_launches=dict(moe_cli=fcli["moe"]["launches"][2],
                                     adafactor_cli=fcli["optimizers"]["adafactor"]["launches"][2],
                                     lion_cli=fcli["optimizers"]["lion"]["launches"][2]),
             max_abs_err=max(max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]) for r in bwd_rows),
             tolerance={r["dtype"]: r["tolerance"] for r in bwd_rows},
             ms=bwd_t["dkv_ms"], plain_ms=bwd_t["plain_ms"], bound_ms=bwd_t["dkv_bound_ms"],
             bound_by=bwd_t["dkv_bound_by"], library_ms=bwd_t["sdpa_bwd_ms"],
             f32=bwd_f32_record("dkv")),
    ]}
    record = dict(nvidia_smi=smi, device=kind, torch=torch.__version__, cuda=torch.version.cuda,
                  build_seconds=build_s, parity=dense_rows + sparse_rows + quant_rows,
                  quantize_times=quant_times, add_latency=lat, segment_sum=seg_rows, headline=head,
                  pipelined_headline=pipe, dense_path=dense, bf16_path=bf16, criteo=crit,
                  native_build_seconds=native_s,
                  ctr=ctr, ctr_agree_and_pull=agree, model_evaluation=evals,
                  kkt=kkt, encoded_wire=enc, bits_wire=bw, stream_wire=stream, adaptive_tau=tau,
                  bigtable=big, darlin=dar,
                  kernels=kernel_line["kernels"],
                  run_to_run_deterministic=deterministic, flash=flash_rows, lm_serving=lm,
                  flash_bwd=bwd_rows, flash_bwd_times=bwd_t, flash_bwd_times_f32=bwd_f32,
                  tf32_mma_sync_tflop_per_s=mma_rate,
                  lm_train=train,
                  lm_train_agreement=agree_train, lm_cli=cli, lm_family=fam, serving=serve,
                  telemetry=tel, wall_s=time.perf_counter() - t_start)
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
