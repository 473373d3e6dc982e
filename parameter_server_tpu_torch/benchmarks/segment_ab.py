"""The segment-sum and quantize kernels of this checkout against another
build (an earlier commit's source), in one process on one card, timed in
turns: other, this, this, other (with ``--variant``, the diagnostic builds
``SEGMENT_NO_SUMS`` and ``QUANTIZE_STOP=1`` / ``2`` in between; their
results are incomplete and fail the check).

    python3 -m parameter_server_tpu_torch.benchmarks.segment_ab --other DIR [--reps 20]
        [--variant MACRO ...]

DIR holds the other ``segment_sum.cu`` and ``quantize.cu`` and the headers
they include, for example ``git archive <commit>
parameter_server_tpu_torch/kernels/csrc`` unpacked; they are built with
the port's own flags into DIR. The other ``quantize.cu`` is the one before
the range was fused in: ``quantize_launch(x, lo, hi, q, num_bytes, n,
seed, stream)``, its range reduced outside (``aminmax``, an add and a
``maximum``: three more launches). The cases:

- segment sums (:func:`segment_inputs`): the CTR step's shard gradient by
  slot (one 10,000-row minibatch of ``benchmarks/ctr.py`` data through the
  conf's tail filter: hot keys, runs of thousands), the headline step's Xw
  by row and its gradient by slot. Each build: its launch alone on the
  sorted input (both builds take it) into an output left as it stands,
  the kernel with its zeroed output, and the whole segment sum as that
  build's step takes it: the other build sorts every call; this one skips
  the sort where the ids come grouped (Xw by row);
- quantize at P 2^22 (the CTR conf's table), b = 1 and b = 2: each build's
  whole function; the other build's kernel alone given ``lo`` and ``hi``,
  and its range alone, beside.

Each turn gives each case's median time over ``--reps`` launches on a
cold L2 (``timing.median_ms``). Before timing, every build's results are
checked: segment sums bit-equal to the CPU's ``index_add_``; ``lo``, ``hi``
and codes bit-equal to the plain version (the other build's range is its
own, without the ``+ 0.0``); the exit code is 1 if one is not. Prints one
line a turn, each case's bound (``segment_bytes.py``: the larger of the
bytes and the serial floor, from the dependent-add latency measured here;
quantize: one read of x and the codes), and writes
``chiprun_out/segment_ab.json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import sys
import tempfile

import torch

from .. import kernels
from ..apps.linear.async_sgd import AsyncSGDWorker, prep_batch_shared
from ..filter import fixing_float
from ..ops import quantize as qops
from ..ops import segment_sum as seg
from ..ops.kv_ops import localize
from ..parameter.parameter import KeyDirectory
from . import segment_bytes
from .ctr import ctr_minibatches
from .flash_ab import build_other, nvidia_smi, turn_order
from .headline import MB, SLOTS, make_batch
from .kernel_report import ROOT
from .timing import median_ms

QUANT_P, QUANT_FRAC, QUANT_SEED = 1 << 22, 0.05, 5
HBM_BYTES_PER_S = 3.35e12
_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
# the C interfaces before this checkout's: quantize.cu before the range was
# fused in, segment_sum.cu before its add-latency probe
OTHER_QUANTIZE = {"quantize_launch": [_P, _P, _P, _P, _I, _LL, _U, _P]}
OTHER_SEGMENT = {"segment_sum_launch": [_P, _P, _I, _P, _I, _P]}


def segment_inputs(seed: int, gen, device: str = "cuda"):
    """The linear step's segment sums on real batches' index vectors:
    ``(name, data, ids, segments, grouped)`` for the headline step's Xw by
    row (rows in CSR order, the padding at row 0 with value 0: grouped),
    its gradient by deduplicated slot, its dense variant's shard gradient
    by slot (sorted unique slots, the padding moved to slot 0: grouped),
    and the CTR step's shard gradient by slot (the hashed step's, on one
    10,000-row minibatch of ``benchmarks/ctr.py`` data read through the
    conf's tail filter). Values drawn from ``gen``, zero where the step's
    are."""
    batch = make_batch(seed)
    nnz_pad = max(4096, -(-int(batch.nnz * 1.25) // 4096) * 4096)
    uniq = -(-min(nnz_pad, SLOTS) // 1024) * 1024
    pb = prep_batch_shared(batch, KeyDirectory(SLOTS, hashed=True), 1, MB, nnz_pad, uniq, SLOTS)
    vals = torch.as_tensor(pb.vals[0]).to(device)
    rel, ok = localize(torch.as_tensor(pb.uslots[0]).to(device), SLOTS)
    with tempfile.TemporaryDirectory(prefix="ctr_segment_") as tmp:
        batches, conf = ctr_minibatches(tmp, 10_000, seed)
    ctr_worker = AsyncSGDWorker(conf, device="cpu")  # its prep only
    hb = ctr_worker.prep(batches[0], device_put=False)
    c_rel, c_ok = localize(torch.as_tensor(hb.slots[0]).to(device), ctr_worker.num_slots)

    def draw(n):
        return torch.randn(n, device=device, generator=gen)

    return [
        ("Xw by row", vals * draw(nnz_pad), torch.as_tensor(pb.rows[0]).to(device), MB, True),
        ("gradient by slot", vals * draw(nnz_pad), torch.as_tensor(pb.ucols[0]).to(device), uniq,
         False),
        ("shard gradient by slot", torch.where(ok, draw(uniq), 0.0), torch.where(ok, rel, 0), SLOTS,
         True),
        ("CTR shard gradient by slot",
         torch.where(c_ok, torch.as_tensor(hb.vals[0]).to(device) * draw(c_rel.numel()), 0.0),
         c_rel, ctr_worker.num_slots, False),
    ]


def _segment_kernel(lib, data, ids, n):
    out = torch.zeros(n, device=data.device)
    kernels.check(lib.segment_sum_launch(data.data_ptr(), ids.data_ptr(), data.numel(),
                                         out.data_ptr(), n, torch.cuda.current_stream().cuda_stream),
                  "segment_sum")
    return out


def _segment_launch(lib, data, ids, out):
    """The kernel's launch alone, into ``out`` as it stands (not zeroed)."""
    kernels.check(lib.segment_sum_launch(data.data_ptr(), ids.data_ptr(), data.numel(),
                                         out.data_ptr(), out.numel(),
                                         torch.cuda.current_stream().cuda_stream), "segment_sum")


def _segment_whole(lib, build, data, ids, n, grouped):
    """The segment sum as ``build``'s step takes it."""
    if grouped and build != "other":
        return _segment_kernel(lib, data, ids.to(torch.int32), n)
    return _segment_kernel(lib, *seg.sort_by_segment(data, ids, n), n)


def _quantize_this(lib, x, nb):
    q = torch.empty(x.numel(), dtype=fixing_float.code_dtype(nb), device=x.device)
    lo_hi = torch.empty(2, device=x.device)
    partials = torch.empty(3 * qops.PARTIAL_BLOCKS, device=x.device)
    kernels.check(lib.quantize_launch(x.data_ptr(), x.numel(), nb, QUANT_SEED, q.data_ptr(),
                                      lo_hi[0].data_ptr(), lo_hi[1].data_ptr(), partials.data_ptr(),
                                      qops.PARTIAL_BLOCKS, torch.cuda.current_stream().cuda_stream),
                  "quantize")
    return q, lo_hi[0], lo_hi[1]


def _other_range(x):
    lo, top = torch.aminmax(x)
    return lo, torch.maximum(top, lo + 1e-12)


def _quantize_other_kernel(lib, x, lo, hi, nb):
    q = torch.empty(x.numel(), dtype=fixing_float.code_dtype(nb), device=x.device)
    kernels.check(lib.quantize_launch(x.data_ptr(), lo.data_ptr(), hi.data_ptr(), q.data_ptr(), nb,
                                      x.numel(), QUANT_SEED, torch.cuda.current_stream().cuda_stream),
                  "quantize")
    return q


def _quantize_whole(lib, build, x, nb):
    if build != "other":
        return _quantize_this(lib, x, nb)
    lo, hi = _other_range(x)
    return _quantize_other_kernel(lib, x, lo, hi, nb), lo, hi


def _bits(t):
    return t.view(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="directory with the other kernel sources and their headers")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", default=[], metavar="MACRO",
                    help="also time this checkout built with -DMACRO (A+B: both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    other = args.other.resolve()
    libs = {"segment_sum": {"other": build_other("segment_sum", other, OTHER_SEGMENT),
                            "this": kernels.library("segment_sum")},
            "quantize": {"other": build_other("quantize", other, OTHER_QUANTIZE),
                         "this": kernels.library("quantize")}}
    for macro in args.variant:
        for name in libs:
            libs[name][macro] = kernels.variant(name, *macro.split("+"))
    builds = list(libs["segment_sum"])
    lat = segment_bytes.add_latency()
    print(f"# dependent f32 add: {lat['cycles_per_add']:.3f} cycles, {lat['ns_per_add']:.4f} ns, "
          f"SM clock {lat['sm_clock_mhz']:.0f} MHz [{smi}]", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases, ok = [], True
    for name, data, ids, n, grouped in segment_inputs(args.seed + 2_000_000, gen):
        if name == "shard gradient by slot":
            continue  # the dense variant's: off the headline and CTR ministeps
        want = seg.segment_sum(data.cpu(), ids.cpu(), n)
        sdata, sids = seg.sort_by_segment(data, ids, n)
        need = segment_bytes.counts(data, ids, n)
        b_ms, b_by = segment_bytes.bound(need, lat["ns_per_add"])
        bit_equal = {}
        for build in builds:
            lib = libs["segment_sum"][build]
            got = [_segment_kernel(lib, sdata, sids, n), _segment_whole(lib, build, data, ids, n, grouped)]
            torch.cuda.synchronize()
            bit_equal[build] = all(torch.equal(_bits(g.cpu()), _bits(want)) for g in got)
        ok = ok and all(bit_equal.values())
        cases.append(dict(
            name=name, kind="segment_sum", grouped=grouped, **need, bound_ms=b_ms, bound_by=b_by,
            bytes_ms=segment_bytes.ms(need["bytes"]),
            serial_floor_ms=segment_bytes.serial_floor_ms(need["longest"], lat["ns_per_add"]),
            bit_equal=bit_equal,
            runs={"launch": lambda lib, build, d=sdata, i=sids, o=torch.zeros(n, device="cuda"):
                      _segment_launch(lib, d, i, o),
                  "kernel": lambda lib, build, d=sdata, i=sids, n=n: _segment_kernel(lib, d, i, n),
                  "whole": lambda lib, build, d=data, i=ids, n=n, g=grouped:
                      _segment_whole(lib, build, d, i, n, g)}))
    # one launch of each kernel on a handful of entries: the least a call
    # reads on this timer
    tiny, tiny_ids = torch.ones(128, device="cuda"), torch.zeros(128, dtype=torch.int32, device="cuda")
    cases.append(dict(name="segment_sum 128 entries", kind="segment_sum", bit_equal={},
                      runs={"launch": lambda lib, build, o=torch.zeros(1, device="cuda"):
                            _segment_launch(lib, tiny, tiny_ids, o)}))
    cases.append(dict(name="quantize 128 entries", kind="quantize", bit_equal={},
                      runs={"whole": lambda lib, build: _quantize_whole(lib, build, tiny, 1)}))
    for nb in (1, 2):
        x = torch.randn(QUANT_P, device="cuda", generator=gen)
        x[torch.rand(QUANT_P, device="cuda", generator=gen) > QUANT_FRAC] = 0.0
        bit_equal = {}
        for build in builds:
            q, lo, hi = _quantize_whole(libs["quantize"][build], build, x, nb)
            lo_p, hi_p = _other_range(x) if build == "other" else fixing_float.quantize_range(x)
            qp = fixing_float.quantize_codes(x, lo_p, hi_p, QUANT_SEED, nb)
            torch.cuda.synchronize()
            bit_equal[build] = (torch.equal(q.view(torch.uint8), qp.view(torch.uint8))
                                and torch.equal(_bits(torch.stack([lo, hi])), _bits(torch.stack([lo_p, hi_p]))))
        ok = ok and all(bit_equal.values())
        lo_o, hi_o = _other_range(x)
        cases.append(dict(
            name=f"quantize P 2^22 b={nb}", kind="quantize", bytes=QUANT_P * (4 + nb),
            bound_ms=QUANT_P * (4 + nb) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bit_equal=bit_equal,
            runs={"whole": lambda lib, build, x=x, nb=nb: _quantize_whole(lib, build, x, nb),
                  "kernel": lambda lib, build, x=x, nb=nb, lo=lo_o, hi=hi_o:
                      _quantize_other_kernel(lib, x, lo, hi, nb),
                  "range": lambda lib, build, x=x: _other_range(x)},
            other_only=("kernel", "range")))

    turns = []
    for build in turn_order(args.variant):
        t = {"build": build}
        for case in cases:
            lib = libs[case["kind"]][build]
            t[case["name"]] = {
                what: median_ms(lambda run=run: run(lib, build), args.reps)
                for what, run in case["runs"].items()
                if build == "other" or what not in case.get("other_only", ())}
        turns.append(t)
        print(f"# turn {len(turns)} ({build}): " + "; ".join(
            f"{name} " + ", ".join(f"{what} {ms:.4f} ms" for what, ms in v.items())
            for name, v in t.items() if name != "build") + f" [{smi}]", flush=True)
    for case in cases:
        if "bound_ms" not in case:
            continue
        extra = (f", longest run {case['longest']}, bytes {case['bytes_ms']:.4f} ms, serial floor "
                 f"{case['serial_floor_ms']:.4f} ms" if case["kind"] == "segment_sum" else "")
        print(f"# {case['name']}: bound {case['bound_ms']:.4f} ms ({case['bound_by']}{extra}); "
              f"bit-equal by build {case['bit_equal']} [{smi}]", flush=True)
    record = dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0), reps=args.reps,
                  add_latency=lat,
                  cases=[{k: v for k, v in c.items() if k not in ("runs", "other_only")} for c in cases],
                  turns=turns)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "segment_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
