"""Mixture-of-experts FFN with top-1 (switch) routing and expert parallelism.

Counterpart of ``parameter_server_tpu/models/moe.py``: :func:`init_moe`,
:func:`_route`, :func:`_expert_ffn`, :func:`moe_ffn_dense` and
:func:`moe_ffn`. Each token goes to the expert of its largest gate (the
first on ties, as ``jnp.argmax``), takes the next slot of that expert's
buffer in the flattened ``[B, S]`` arrival order, and is dropped when
the buffer's ``capacity`` slots are full (it then passes through on the
residual path). The experts run as batched matmuls over ``[E, C, d]``
buffers and each kept token's output comes back scaled by its gate.

The JAX package builds ``[T, E, C]`` dispatch and combine one-hots and
moves tokens with two einsums. At the LM CLI's full shape (T 32,768
tokens, 8 experts, C 8,192) one such tensor would hold 2.1e9 floats.
This port computes the same routing by index arithmetic instead: the
slot of a token is ``expert * C + position``, the buffers are a gather
of the tokens by slot and the output a gather of the buffers by token.
Nothing larger than ``[T, E]`` or ``[E, C, d_ff]`` is built, so memory
stays linear in T (``tests/test_torch_moe.py`` records every tensor a
call makes). The gathers reproduce the einsums exactly: each slot of the
dispatch einsum has at most one nonzero term (the one token routed
there, times 1.0), and so does each token of the combine einsum (its
gate times its slot's output), so a sum that adds zeros to one product
is that product. Empty slots hold zeros, as the einsum leaves them, and
their expert outputs are never read. Gradients reach the router only
through the gate, as in JAX: the argmax, the positions and the drop
mask carry none.

:func:`moe_ffn` is the expert-parallel layer: the experts are sharded
over an axis of the mesh (E % n == 0), each rank routes its own sequence
shard's tokens with the per-shard capacity into ``[E, C, d]`` buffers,
one all-to-all sends each expert's buffer to the rank that holds the
expert (``[E/n, n*C, d]`` there), the rank's ``E/n`` experts run, and
the inverse all-to-all brings the outputs back for the combine. As in
the JAX layer the tables arrive whole (replicated) and each rank takes
its slice, so a rank's gradient of a table is nonzero in its slice
alone and the data axis's sum of the ranks' gradients is the JAX
layer's (``models/transformer.value_and_grad`` makes that sum). On an
axis of size 1 (or with no mesh) it is ``moe_ffn_dense(n_shards=1)``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel import mesh as meshlib

Params = Dict[str, torch.Tensor]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int) -> Params:
    """``router`` [d, E], ``w_in`` [E, d, d_ff], ``w_out`` [E, d_ff, d]:
    normal draws scaled by 1/sqrt(fan-in), as the JAX ``init_moe``, drawn
    in that order from ``generator`` (values differ from JAX's keys)."""

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=generator.device)

    return {"router": normal(d_model, n_experts) * (1.0 / math.sqrt(d_model)),
            "w_in": normal(n_experts, d_model, d_ff) * (1.0 / math.sqrt(d_model)),
            "w_out": normal(n_experts, d_ff, d_model) * (1.0 / math.sqrt(d_ff))}


def _route(x, router, n_experts: int, capacity: int):
    """Switch routing of ``x`` [T, d]: (slot [T], gate [T]). ``slot`` is
    ``expert * capacity + position`` for a kept token and ``n_experts *
    capacity`` (one past the buffers) for a dropped one."""
    gates = torch.softmax(x @ router, dim=-1)  # [T, E]
    expert = torch.argmax(gates, dim=-1)  # first index on ties
    gate = gates.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, n_experts)  # [T, E]
    # position of each token within its expert's buffer (arrival order)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, expert[:, None])[:, 0]
    slot = torch.where(pos < capacity, expert * capacity + pos, n_experts * capacity)
    return slot, gate


def _expert_ffn(w_in, w_out, h):
    """relu(h @ w_in) @ w_out per expert: h [E, C, d] -> [E, C, d]."""
    return torch.bmm(torch.relu(torch.bmm(h, w_in)), w_out)


def _moe_tokens(params: Params, xt, capacity: int, experts=None):
    """One shard's tokens ``xt`` [T, d] through routing, the experts and
    the combine. ``experts(h)`` maps the ``[E, C, d]`` buffers to the
    experts' outputs (default: every expert of ``params``, here)."""
    t, d = xt.shape
    n_experts = params["router"].shape[1]
    slot, gate = _route(xt, params["router"], n_experts, capacity)
    n_slots = n_experts * capacity
    # the token of each slot; T (a zero row) where the slot stays empty.
    # A dropped token writes the spare entry n_slots, which is cut off.
    src = torch.full((n_slots + 1,), t, dtype=torch.int64, device=xt.device)
    src.scatter_(0, slot, torch.arange(t, device=xt.device))
    padded = torch.cat([xt, xt.new_zeros(1, d)])
    h = padded[src[:n_slots]].reshape(n_experts, capacity, d)
    if experts is None:
        out_e = _expert_ffn(params["w_in"], params["w_out"], h)
    else:
        out_e = experts(h)
    out_e = out_e.reshape(n_slots, d)
    # a dropped token reads the zero row past the buffers
    out = torch.cat([out_e, out_e.new_zeros(1, d)])[slot]
    return out * gate[:, None]


def moe_ffn_dense(params: Params, x, n_shards: int, capacity_factor: float = 1.25):
    """The sharded layer's math on one device: ``x`` [B, S, d] in
    ``n_shards`` sequence slices (all batch rows each), each routed with
    its own capacity ``max(1, int(capacity_factor * T_shard / E))``."""
    b, s, d = x.shape
    n_experts = params["router"].shape[1]
    s_loc = s // n_shards
    t_loc = b * s_loc
    capacity = max(1, int(capacity_factor * t_loc / n_experts))
    outs = []
    for i in range(n_shards):
        xt = x[:, i * s_loc:(i + 1) * s_loc, :].reshape(-1, d)
        outs.append(_moe_tokens(params, xt, capacity).reshape(b, s_loc, d))
    return torch.cat(outs, dim=1)


def moe_ffn(params: Params, x, *, mesh=None, axis: str = "data",
            capacity_factor: float = 1.25):
    """The expert-parallel MoE FFN: ``x`` is this rank's ``[B, S/n, d]``
    sequence shard, the tables whole; returns this rank's shard of the
    output. The experts split over ``axis`` (``ValueError`` unless E %
    n == 0); with no mesh or an axis of size 1,
    ``moe_ffn_dense(params, x, 1, capacity_factor)``."""
    n, r = meshlib.axis_extent(mesh, axis)
    n_experts = params["router"].shape[1]
    if n_experts % n:
        raise ValueError(f"experts {n_experts} must divide mesh axis {n}")
    if n == 1:
        return moe_ffn_dense(params, x, 1, capacity_factor)
    b, s_loc, d = x.shape
    xt = x.reshape(-1, d)
    capacity = max(1, int(capacity_factor * xt.shape[0] / n_experts))
    per = n_experts // n
    lo = r * per
    w_in, w_out = params["w_in"][lo:lo + per], params["w_out"][lo:lo + per]

    def experts(h):  # [E, C, d] -> this rank's experts over every shard's buffer -> [E, C, d]
        h = meshlib.all_to_all(h, axis, mesh, split_axis=0, concat_axis=1)
        return meshlib.all_to_all(_expert_ffn(w_in, w_out, h), axis, mesh, split_axis=1,
                                  concat_axis=0)

    return _moe_tokens(params, xt, capacity, experts).reshape(b, s_loc, d)
