"""Rank functions of the port's tests of the LM's layouts across ranks:
each runs in every process of a gloo world of CPU ranks that
``parallel.launch.run_world`` starts, on a ``world x 1`` mesh, and
returns plain numpy results for the test process to hold against the JAX
package. Imports the port only (no JAX: the ranks never load it).

Inputs arrive whole (the global arrays); each rank cuts its own shard,
as JAX's ``shard_map`` hands each device its block.
"""

import contextlib
import io

import numpy as np
import torch
import torch.distributed as dist

from parameter_server_tpu_torch.models import attention as tatt
from parameter_server_tpu_torch.models import moe as tmoe
from parameter_server_tpu_torch.models import pipeline as tpipe
from parameter_server_tpu_torch.models import transformer as T
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parallel import ring

AX = meshlib.DATA_AXIS


def _mesh():
    return meshlib.make_mesh(num_data=dist.get_world_size(), num_server=1, device="cpu")


def _shard(a, m, dim):
    """This rank's block of the global array ``a`` along ``dim``."""
    t = torch.as_tensor(np.asarray(a))
    n, r = m.shape[AX], m.data_index
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size).contiguous()


# -- the collectives and the ring --

#: each collective on a rank's [4, 8, 4] shard (the global array [16, 8,
#: 4], sharded on dim 0); the test runs its JAX counterpart alike
COLLECTIVES = {
    "shift+1": lambda x, m: meshlib.shift(x, AX, m, 1),
    "shift-1": lambda x, m: meshlib.shift(x, AX, m, -1),
    "shift+2": lambda x, m: meshlib.shift(x, AX, m, 2),
    "all_to_all 0->1": lambda x, m: meshlib.all_to_all(x, AX, m, 0, 1),
    "all_to_all 1->0": lambda x, m: meshlib.all_to_all(x, AX, m, 1, 0),
    "all_to_all 2->1": lambda x, m: meshlib.all_to_all(x, AX, m, 2, 1),
    "all_to_all untiled 0->2": lambda x, m: meshlib.all_to_all(x, AX, m, 0, 2, tiled=False),
    "psum": lambda x, m: meshlib.psum(x, AX, m),
}


def ring_world(x, cts, invariant_ct):
    """The ring functions on this rank's shard of ``x`` [16, 8, 4], each
    collective's value and its gradient for the cotangent ``cts[name]``
    (global, sharded like the output), :func:`..mesh.psum_invariant`'s
    for the replicated ``invariant_ct``, and ``shift_all`` of a pair."""
    m = _mesh()
    xs = _shard(x, m, 0)
    out = {
        "allreduce": ring.ring_allreduce(xs, AX, mesh=m).numpy(),
        "allgather": ring.ring_allgather(xs, AX, mesh=m).numpy(),
        "scan": ring.ring_scan(xs, AX, lambda acc, blk, step: acc + blk * (step + 1),
                               torch.zeros_like(xs), mesh=m).numpy(),
        "next": ring.ring_next(xs, AX, mesh=m).numpy(),
    }
    for name, fn in COLLECTIVES.items():
        t = xs.clone().requires_grad_()
        y = fn(t, m)
        (g,) = torch.autograd.grad(y, t, _shard(cts[name], m, 0))
        out[name] = (y.detach().numpy(), g.numpy())
    t = xs.clone().requires_grad_()
    y = meshlib.psum_invariant(t, AX, m)
    (g,) = torch.autograd.grad(y, t, torch.as_tensor(invariant_ct))
    out["psum_invariant"] = (y.detach().numpy(), g.numpy())
    a, b = xs.clone().requires_grad_(), (2 * xs).clone().requires_grad_()
    ya, yb = meshlib.shift_all((a, b), AX, m, 1)
    ga, gb = torch.autograd.grad((ya * yb).sum(), (a, b))
    out["shift_all"] = (ya.detach().numpy(), yb.detach().numpy(), ga.numpy(), gb.numpy())
    return out


# -- attention --


def attention_world(groups):
    """Each group ``(cases, q, k, v, dy)``: each case ``(name, fn,
    kwargs)`` (``fn`` ``"ring"`` or ``"ulysses"``) on this rank's sequence
    shard of the group's global ``[B, S, H]`` inputs (the zigzag cases'
    already in the zigzag layout): the output shard and the gradients of
    ``sum(out * dy)``."""
    m = _mesh()
    out = {}
    for cases, q, k, v, dy in groups:
        for name, fn, kw in cases:
            xs = [_shard(a, m, 1).requires_grad_() for a in (q, k, v)]
            f = tatt.ring_attention if fn == "ring" else tatt.ulysses_attention
            y = f(*xs, mesh=m, axis=AX, **kw)
            grads = torch.autograd.grad(y, xs, _shard(dy, m, 1))
            out[name] = (y.detach().numpy(), *[g.numpy() for g in grads])
    return out


# -- MoE and the pipeline --


def moe_world(params, x, dy, capacity_factors):
    """``moe_ffn`` on this rank's sequence shard of ``x`` [B, S, d] at
    each capacity factor: the output shard; at the first, the tables'
    gradients of ``sum(out * dy)`` summed over the axis
    (``value_and_grad``'s sum) and the input shard's gradient."""
    m = _mesh()
    out = {}
    for cf in capacity_factors:
        leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in params.items()}
        xs = _shard(x, m, 1).requires_grad_()
        y = tmoe.moe_ffn(leaves, xs, mesh=m, axis=AX, capacity_factor=cf)
        if cf == capacity_factors[0]:
            grads = torch.autograd.grad(y, [*leaves.values(), xs], _shard(dy, m, 1))
            summed = meshlib.psum_tree(dict(zip(leaves, grads)), AX, m)
            out["grads"] = {k: g.numpy() for k, g in summed.items()}
            out["dx"] = grads[-1].numpy()
        out[cf] = y.detach().numpy()
    return out


def moe_pipeline_world(params, x, dy, capacity_factors, pipes):
    """:func:`moe_world` and :func:`pipeline_world` in one world."""
    return {"moe": moe_world(params, x, dy, capacity_factors), "pipeline": pipeline_world(pipes)}


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_world(cases):
    """Each case ``(name, params, x)``: ``pipeline_apply`` over the axis's
    stage groups, its output (the same on every rank) and the gradients
    of ``sum(out ** 2)``, summed over the axis. A stage count that is no
    multiple of the axis raises before any collective: its message."""
    m = _mesh()
    out = {}
    for name, params, x in cases:
        leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in params.items()}
        try:
            y = tpipe.pipeline_apply(_stage_fn, leaves, torch.as_tensor(x), mesh=m, axis=AX)
        except ValueError as e:
            out[name] = str(e)
            continue
        grads = torch.autograd.grad((y ** 2).sum(), list(leaves.values()))
        summed = meshlib.psum_tree(dict(zip(leaves, grads)), AX, m)
        out[name] = (y.detach().numpy(), {k: g.numpy() for k, g in summed.items()})
    return out


# -- the LM on a sequence shard --


def lm_world(cases, tokens, steps, lr):
    """Each case ``(name, cfg kwargs, params)`` with this rank's shard of
    the global ``tokens`` [B, S] (zigzag-permuted through
    ``zigzag_lm_arrays`` under ``ring_zigzag``): the logits shard, the
    loss and the summed gradients, then ``steps`` SGD steps' losses and
    the final parameters."""
    m = _mesh()
    n = m.shape[AX]
    out = {}
    for name, kw, params in cases:
        cfg = T.LMConfig(**kw)
        p = {k: torch.as_tensor(v) for k, v in params.items()}
        if cfg.attention == "ring_zigzag":
            data = tuple(T.shard_tokens(a, m) for a in T.zigzag_lm_arrays(tokens, n))

            def loss_fn(leaves, data=data, cfg=cfg):
                return T.lm_loss_with_targets(leaves, *data, cfg, mesh=m)

            step = T.make_lm_train_step_with_targets(cfg, lr=lr, mesh=m)
        else:
            data = (T.shard_tokens(tokens, m),)

            def loss_fn(leaves, data=data, cfg=cfg):
                return T.lm_loss(leaves, *data, cfg, mesh=m)

            step = T.make_lm_train_step(cfg, lr=lr, mesh=m)
        with torch.no_grad():
            logits = T.lm_forward(p, data[0], cfg, mesh=m).numpy()
        loss, grads = T.value_and_grad(loss_fn, p, mesh=m)
        losses = []
        for _ in range(steps):
            p, sl = step(p, *data)
            losses.append(float(sl))
        out[name] = dict(logits=logits, loss=float(loss),
                         grads={k: g.numpy() for k, g in grads.items()}, losses=losses,
                         params={k: v.numpy() for k, v in p.items()})
    return out


# -- the LM CLI in a world --


def cli_world(runs):
    """The LM CLI on this rank once a run ``(argv, params_file)``, with the
    port's ``init_lm`` returning the float32 weights saved in
    ``params_file`` (the JAX ``init_lm``'s, carried across by
    ``convert``): each run's exit code and what it printed (rank 0 alone
    prints)."""
    from parameter_server_tpu_torch.apps.lm import main as lm_main

    real = T.init_lm
    out = []
    try:
        for argv, params_file in runs:
            saved = dict(np.load(params_file))
            T.init_lm = lambda seed, cfg, device=None, saved=saved: {
                k: torch.as_tensor(v).to(device) for k, v in saved.items()}
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = lm_main.main(list(argv))
            out.append((code, buf.getvalue()))
    finally:
        T.init_lm = real
    return out
