"""The LM trained with its sequence across ranks, and with its
parameters and optimizer state placed across them, measured.

Rank functions for ``parallel/launch.run_world`` (``chip_smoke.py``'s
phases 9g and 9h): every rank of a world runs one, and the caller holds
the results against one card. On one card the ranks
share it and talk gloo, so each number here is of ranks sharing one card
over gloo (every shift and all-to-all of a CUDA tensor staged through
pinned host memory), not of NCCL across cards.

- :func:`schedules`: (a) ring attention (``xla``, ``flash``, ``zigzag``)
  and Ulysses attention (``xla``, ``flash``) on this rank's sequence shard
  of seeded global inputs (:func:`attention_inputs`), the output shard
  and the q, k, v gradients of ``sum(out * dy)``; (b) ``moe_ffn`` with
  the experts sharded over the ranks and ``pipeline_apply`` over the
  ranks' stage groups, the outputs and the gradients summed over the
  ranks.
- :func:`cli_runs`: the LM CLI (``apps/lm/main.main``) once an argv, as
  every rank of a launcher's world runs it; rank 0's output, each rank's
  peak memory.
- :func:`schedules_and_cli`: both in one world (one start of its ranks).
- :func:`placed_bytes`: this rank's bytes of parameters and optimizer
  state as the CLI places them for an argv (Megatron, FSDP, ZeRO-1).
- :func:`tp_decode`: greedy decoding, beam search and speculative
  decoding on a checkpoint's weights placed by ``shard_lm_params`` over
  the world's server row.
- :func:`cli_and_decode`: :func:`cli_runs`, then :func:`tp_decode`.

Each part counts the three flash kernels' launches from zero and returns
the counts (``launches``), with its losses or outputs and its wall
times. On the card each part holds this rank's first launch of each
flash kernel at nonzero offsets (the ring's hops) to its plain version on
that launch's own inputs, within the tolerances the caller passes (a
launch made for the comparison is not counted).
"""

from __future__ import annotations

import contextlib
import io
import time
from typing import Dict, List, Sequence

import torch

from ..ops import flash_attention as fa
from ..parallel import mesh as meshlib

AX = meshlib.DATA_AXIS


def _mesh(device):
    return meshlib.make_mesh(num_data=torch.distributed.get_world_size(), num_server=1,
                             device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset() -> None:
    for fn in (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        fn.launches = 0


def _launches() -> Dict[str, int]:
    return {"flash_fwd": int(fa.flash_attention.launches),
            "flash_bwd_dq": int(fa.flash_bwd_dq.launches),
            "flash_bwd_dkv": int(fa.flash_bwd_dkv.launches)}


@contextlib.contextmanager
def first_offset_calls(any_offset: bool = False):
    """Records this process's first ``flash_fwd`` launch and first call of
    the backward pair (``fa._backward``) at nonzero offsets inside the
    block (tensors cloned), or at any offsets with ``any_offset`` (a rank's
    first launch at its heads, whatever its hop). Neither route counts
    launches on itself, so the counts are untouched."""
    seen: dict = {}
    fwd, bwd = fa.launch_kernel, fa._backward

    def launch(q, k, v, q_offset=0, k_offset=0, **kw):
        if "fwd" not in seen and (any_offset or int(q_offset) or int(k_offset)):
            seen["fwd"] = ([t.detach().clone() for t in (q, k, v)], int(q_offset),
                           int(k_offset), dict(kw))
        return fwd(q, k, v, q_offset, k_offset, **kw)

    def backward(q, k, v, do, lse, c, q_offset, k_offset, causal, window, group):
        if "bwd" not in seen and (any_offset or int(q_offset) or int(k_offset)) and q.is_cuda:
            seen["bwd"] = ([t.detach().clone() for t in (q, k, v, do, lse, c)], int(q_offset),
                           int(k_offset), dict(causal=causal, window=window, group=group))
        return bwd(q, k, v, do, lse, c, q_offset, k_offset, causal, window, group)

    fa.launch_kernel, fa._backward = launch, backward
    try:
        yield seen
    finally:
        fa.launch_kernel, fa._backward = fwd, bwd


def _within(got, want, rtol: float, atol: float, what: str) -> float:
    """|got - want| <= atol + rtol |want| everywhere, else raise; returns
    the largest share of that bound used."""
    diff = (got.float() - want.float()).abs()
    used = float((diff / (atol + rtol * want.float().abs())).max())
    if not used <= 1.0:
        raise RuntimeError(f"{what}: max |diff| {float(diff.max())} past the tolerance (rtol "
                           f"{rtol}, atol {atol})")
    return used


def hold_to_plain(seen: dict, fwd_tol: dict, bwd_tol: dict, rows: int = 8) -> dict:
    """Each recorded launch against its plain version: ``flash_fwd`` (out,
    and lse) within ``fwd_tol[dtype] = (rtol, atol, lse atol)``; the
    backward pair on the first ``rows`` query rows (the plain version's
    float32 scores of all of them would not fit) within ``bwd_tol[dtype]
    = (rtol, atol as a share of each gradient's largest |plain|)``.
    Raises past a tolerance; the launches made here are not counted."""
    out: dict = {}
    before = _launches()
    if "fwd" in seen:
        (q, k, v), qo, ko, kw = seen["fwd"]
        got, lse = fa.launch_kernel(q, k, v, qo, ko, **kw)
        want, want_lse = fa._flash_plain(q, k, v, qo, ko, kw["causal"], kw["window"],
                                         kw["group"])
        rtol, atol, lse_atol = fwd_tol[q.dtype]
        out["flash_fwd"] = dict(
            q_offset=qo, k_offset=ko, bh=q.shape[0], sq=q.shape[1], sk=k.shape[1],
            dtype=str(q.dtype).split(".")[-1],
            fully_masked_rows=int((want_lse <= fa._NEG / 2).sum()),
            max_abs_err=float((got.float() - want.float()).abs().max()),
            tolerance_used=max(_within(got, want, rtol, atol, "flash_fwd out"),
                               _within(lse, want_lse, 0.0, lse_atol, "flash_fwd lse")))
    if "bwd" in seen:
        (q, k, v, do, lse, c), qo, ko, kw = seen["bwd"]
        g = kw["group"]
        n = min(rows, q.shape[0])
        q, do, lse, c, k, v = q[:n], do[:n], lse[:n], c[:n], k[:n // g], v[:n // g]
        got = (fa.flash_bwd_dq(q, k, v, do, lse, c, qo, ko, **kw),
               *fa.flash_bwd_dkv(q, k, v, do, lse, c, qo, ko, **kw))
        with torch.no_grad():
            want = fa.flash_attention_bwd_ref(q, k, v, do, lse, c, qo, ko, **kw)
        rtol, share = bwd_tol[q.dtype]
        rec = dict(q_offset=qo, k_offset=ko, bh=n, sq=q.shape[1], sk=k.shape[1],
                   dtype=str(q.dtype).split(".")[-1])
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            scale = max(float(y.float().abs().max()), 1e-30)
            rec[name] = float((x.float() - y.float()).abs().max())
            rec[f"{name}_tolerance_used"] = _within(x, y, rtol, share * scale, f"flash bwd {name}")
        out["flash_bwd"] = rec
    fa.flash_attention.launches = before["flash_fwd"]
    fa.flash_bwd_dq.launches = before["flash_bwd_dq"]
    fa.flash_bwd_dkv.launches = before["flash_bwd_dkv"]
    return out


# -- (a) the attention schedules, (b) MoE and the pipeline --


def attention_inputs(seed: int, shape, dtype, device, zigzag_n: int = 0):
    """Seeded global ``q, k, v, dy`` of ``shape`` (normal draws on
    ``device``, then cast), in the zigzag layout of ``zigzag_n`` ranks when
    it is set: the same tensors in every process on that device type."""
    from ..models.attention import zigzag_permutation

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = [torch.randn(*shape, generator=gen, device=device) for _ in range(4)]
    if zigzag_n:
        perm = torch.as_tensor(zigzag_permutation(shape[1], zigzag_n), device=device)
        out = [t[:, perm] for t in out]
    return [t.to(dtype) for t in out]


def moe_inputs(seed: int, d: int, d_ff: int, n_experts: int, shape, device):
    """Seeded MoE tables (``init_moe``) and ``x``, ``dy`` of ``shape``."""
    from ..models.moe import init_moe

    gen = torch.Generator().manual_seed(int(seed))
    params = init_moe(gen, d, d_ff, n_experts)
    x, dy = (torch.randn(*shape, generator=gen) for _ in range(2))
    return {k: v.to(device) for k, v in params.items()}, x.to(device), dy.to(device)


def pipeline_inputs(seed: int, n_stages: int, d: int, shape, device):
    """Seeded stage tables (``w`` scaled by 1/sqrt(d), ``b``) and
    microbatches ``x`` of ``shape``."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {"w": torch.randn(n_stages, d, d, generator=gen) / d ** 0.5,
              "b": torch.randn(n_stages, d, generator=gen) * 0.1}
    x = torch.randn(*shape, generator=gen)
    return {k: v.to(device) for k, v in params.items()}, x.to(device)


def stage_fn(p, x):
    """One pipeline stage: ``tanh(x @ w + b)``."""
    return torch.tanh(x @ p["w"] + p["b"])


def _shard(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    n, r = mesh.shape[AX], mesh.data_index
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size).contiguous()


def schedules(seed: int, cases: Sequence, moe: dict, pipe: dict, fwd_tol: dict,
              bwd_tol: dict, hold: bool = True) -> dict:
    """Phase 9g (a) and (b) on this rank (module docstring). ``cases``:
    ``(name, fn, kwargs, shape, dtype)``, ``fn`` ``"ring"`` or
    ``"ulysses"``; ``moe``: ``moe_inputs``' arguments and the capacity
    factor; ``pipe``: ``pipeline_inputs``' arguments. Returns each case's
    output shard and gradients (on the CPU), its launches and wall, and
    the part's holds."""
    from ..models import attention as att
    from ..models.moe import moe_ffn
    from ..models.pipeline import pipeline_apply
    from ..parallel import distributed

    device = distributed.rank_device()
    mesh = _mesh(device)
    n = mesh.shape[AX]
    rec: dict = {"rank": mesh.rank, "cases": {}}
    inputs: dict = {}
    _reset()
    with first_offset_calls() if hold and device.type == "cuda" else \
            contextlib.nullcontext({}) as seen:
        for name, fn, kw, shape, dtype in cases:
            zig = kw.get("impl") == "zigzag"
            key = (tuple(shape), dtype, zig)
            if key not in inputs:
                inputs[key] = attention_inputs(seed, shape, dtype, device, n if zig else 0)
            q, k, v, dy = inputs[key]
            xs = [_shard(t, mesh, 1).requires_grad_() for t in (q, k, v)]
            before = _launches()
            _sync(device)
            t0 = time.perf_counter()
            f = att.ring_attention if fn == "ring" else att.ulysses_attention
            y = f(*xs, mesh=mesh, axis=AX, **kw)
            grads = torch.autograd.grad(y, xs, _shard(dy, mesh, 1))
            _sync(device)
            wall = time.perf_counter() - t0
            after = _launches()
            rec["cases"][name] = dict(
                out=y.detach().cpu(), grads=[g.cpu() for g in grads], wall_s=wall,
                launches={key: after[key] - before[key] for key in after})
        params, x, dy = moe_inputs(**moe["inputs"], device=device)
        leaves = {key: t.requires_grad_() for key, t in params.items()}
        xs = _shard(x, mesh, 1).requires_grad_()
        _sync(device)
        t0 = time.perf_counter()
        y = moe_ffn(leaves, xs, mesh=mesh, axis=AX, capacity_factor=moe["capacity_factor"])
        grads = torch.autograd.grad(y, [*leaves.values(), xs], _shard(dy, mesh, 1))
        summed = meshlib.psum_tree(dict(zip(leaves, grads)), AX, mesh)
        _sync(device)
        rec["moe"] = dict(out=y.detach().cpu(), dx=grads[-1].cpu(),
                          grads={key: g.cpu() for key, g in summed.items()},
                          wall_s=time.perf_counter() - t0)
        params, x = pipeline_inputs(**pipe, device=device)
        leaves = {key: t.requires_grad_() for key, t in params.items()}
        _sync(device)
        t0 = time.perf_counter()
        y = pipeline_apply(stage_fn, leaves, x, mesh=mesh, axis=AX)
        grads = torch.autograd.grad((y ** 2).sum(), list(leaves.values()))
        summed = meshlib.psum_tree(dict(zip(leaves, grads)), AX, mesh)
        _sync(device)
        rec["pipeline"] = dict(out=y.detach().cpu(),
                               grads={key: g.cpu() for key, g in summed.items()},
                               wall_s=time.perf_counter() - t0)
    rec["launches"] = _launches()
    rec["held"] = hold_to_plain(seen, fwd_tol, bwd_tol) if seen else {}
    return rec


# -- (c), (d) the LM CLI in a world --


def placed_bytes(argv: Sequence[str], device) -> Dict[str, int]:
    """This rank's bytes of the parameters and of the optimizer state the
    LM CLI places for ``argv`` (``apps/lm/main.place``: its widths, seed,
    optimizer, ``--num-servers``, ``--fsdp``, ``--zero1``) in this world.
    Every rank of the world calls it (the mesh's groups are collective)."""
    from ..apps.lm import main as lm_main
    from ..apps.lm import optim
    from ..models.transformer import init_lm
    from ..parallel import placement

    args = lm_main._parser().parse_args(list(argv))
    world = torch.distributed.get_world_size()
    mesh = meshlib.make_mesh(num_data=world // args.num_servers, num_server=args.num_servers,
                             device=device)
    tx = optim.build(args.lr, args.steps, args.warmup, args.clip_norm, args.grad_accum,
                     args.optimizer)
    params, opt = lm_main.place(args, init_lm(args.seed, lm_main.config(args), device), tx, mesh)
    out = {"params": placement.nbytes(params), "opt": placement.nbytes(opt)}
    del params, opt
    return out


def cli_runs(argvs: Sequence[List[str]], fwd_tol: dict, bwd_tol: dict,
             hold: bool = True, any_offset: Sequence[bool] = (),
             sizes: Sequence[bool] = ()) -> List[dict]:
    """Phases 9g (c) / (d) and 9h on this rank: the LM CLI once an argv, as
    a launcher's world runs it. Each run's exit code, rank 0's output, the
    run's flash launches (from zero), wall, this rank's peak device
    memory and, on the card, the holds of its first launches at nonzero
    offsets (at any offsets where ``any_offset[i]``); where ``sizes[i]``,
    this rank's bytes of parameters and optimizer state
    (:func:`placed_bytes`)."""
    from ..apps.lm import main as lm_main
    from ..parallel import distributed

    device = distributed.rank_device()
    out = []
    for i, argv in enumerate(argvs):
        _reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        buf = io.StringIO()
        _sync(device)
        t0 = time.perf_counter()
        anywhere = i < len(any_offset) and any_offset[i]
        with first_offset_calls(anywhere) if hold and device.type == "cuda" else \
                contextlib.nullcontext({}) as seen:
            with contextlib.redirect_stdout(buf):
                code = lm_main.main(list(argv))
        _sync(device)
        run = dict(argv=list(argv), code=code, text=buf.getvalue(),
                   wall_s=time.perf_counter() - t0, launches=_launches())
        if device.type == "cuda":
            run["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        run["held"] = hold_to_plain(seen, fwd_tol, bwd_tol) if seen else {}
        if i < len(sizes) and sizes[i]:
            run["bytes"] = placed_bytes(argv, device)
        out.append(run)
    return out


def schedules_and_cli(seed: int, cases: Sequence, moe: dict, pipe: dict,
                      argvs: Sequence[List[str]], fwd_tol: dict, bwd_tol: dict,
                      any_offset: Sequence[bool] = (), sizes: Sequence[bool] = ()) -> dict:
    """:func:`schedules`, then :func:`cli_runs`, in one world."""
    return {"schedules": schedules(seed, cases, moe, pipe, fwd_tol, bwd_tol),
            "cli": cli_runs(argvs, fwd_tol, bwd_tol, any_offset=any_offset, sizes=sizes)}


# -- decoding on Megatron's placement --


def restore_params(argv: Sequence[str], ckpt_dir: str, step: int, device):
    """The whole parameters of the LM CLI's checkpoint at ``step`` (its
    run's ``argv`` gives the template: widths, seed, optimizer)."""
    from ..apps.lm import main as lm_main
    from ..apps.lm import optim
    from ..models.transformer import init_lm
    from ..parameter.replica import CheckpointManager

    args = lm_main._parser().parse_args(list(argv))
    params = init_lm(args.seed, lm_main.config(args), device)
    tx = optim.build(args.lr, args.steps, args.warmup, args.clip_norm, args.grad_accum,
                     args.optimizer)
    return CheckpointManager(ckpt_dir).restore(step, like={"params": params,
                                                           "opt": tx.init(params)})["params"]


def decode_calls(params, cfg, spec: dict, mesh=None) -> dict:
    """Greedy ``lm_generate``, ``lm_beam_search`` and
    ``speculative_generate`` (a whole draft of ``spec["draft"]``'s widths
    from ``spec["draft_seed"]``) on ``params`` (placed on ``mesh``, or
    whole) for ``spec["prompt"]``: their tokens on the CPU, and the flash
    launches (from zero) of each."""
    from ..models import transformer as tr
    from ..models.speculative import speculative_generate

    dev = params["emb"].device
    prompt = torch.as_tensor(spec["prompt"], device=dev)
    draft_cfg = tr.LMConfig(**spec["draft"])
    draft = tr.init_lm(spec["draft_seed"], draft_cfg, dev)
    out, launches = {}, {}
    with torch.no_grad():
        for name in ("greedy", "beam", "speculative"):
            _reset()
            if name == "greedy":
                toks = tr.lm_generate(params, prompt, cfg, steps=spec["steps"], mesh=mesh)
            elif name == "beam":
                toks = tr.lm_beam_search(params, prompt, cfg, steps=spec["beam_steps"],
                                         beam_width=spec["beam_width"], mesh=mesh)[0]
            else:
                toks = speculative_generate(params, cfg, draft, draft_cfg, prompt,
                                            steps=spec["steps"], gamma=spec["gamma"], mesh=mesh)
            out[name] = toks.cpu()
            launches[name] = _launches()
    return dict(tokens=out, launches=launches)


def tp_decode(spec: dict, fwd_tol: dict, hold: bool = True) -> dict:
    """On this rank of a world of S ranks: the LM CLI's checkpoint
    (``spec["argv"]``, ``spec["ckpt_dir"]``, ``spec["step"]``) placed by
    ``shard_lm_params`` over a ``1 x S`` mesh, then :func:`decode_calls`;
    every rank decodes alike. On the card each rank's first ``flash_fwd``
    launch (a prefill at this rank's heads) is held to its plain version."""
    from ..apps.lm import main as lm_main
    from ..models.transformer import shard_lm_params
    from ..parallel import distributed

    device = distributed.rank_device()
    world = torch.distributed.get_world_size()
    mesh = meshlib.make_mesh(num_data=1, num_server=world, device=device)
    cfg = lm_main.config(lm_main._parser().parse_args(list(spec["argv"])))
    tp = shard_lm_params(restore_params(spec["argv"], spec["ckpt_dir"], spec["step"], device),
                         mesh)
    with first_offset_calls(True) if hold and device.type == "cuda" else \
            contextlib.nullcontext({}) as seen:
        rec = decode_calls(tp, cfg, spec, mesh)
    rec["held"] = hold_to_plain({k: v for k, v in seen.items() if k == "fwd"}, fwd_tol, {}) \
        if seen else {}
    rec["rank"] = mesh.rank
    return rec


def cli_and_decode(argvs: Sequence[List[str]], fwd_tol: dict, bwd_tol: dict,
                   any_offset: Sequence[bool], sizes: Sequence[bool], decode: dict) -> dict:
    """:func:`cli_runs`, then :func:`tp_decode` of ``decode``, in one world."""
    return {"cli": cli_runs(argvs, fwd_tol, bwd_tol, any_offset=any_offset, sizes=sizes),
            "decode": tp_decode(decode, fwd_tol)}
