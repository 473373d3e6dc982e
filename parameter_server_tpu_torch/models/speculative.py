"""Speculative decoding (Leviathan et al. 2023).

Counterpart of ``parameter_server_tpu/models/speculative.py``: the
acceptance core :func:`_accept_and_correct` and :func:`speculative_generate`
(greedy and sampled, dense and ragged, ``eos_id``, ``return_stats``). A
small DRAFT model proposes ``gamma`` tokens one at a time; the TARGET
model scores all of them in ONE (gamma + 1)-wide cache pass. Greedy, the
output is token for token the target's greedy :func:`lm_generate`;
sampled, every emitted token keeps the target's distribution.

Cache invariant (both models), as in the JAX package: at round start
every position before ``committed - 1`` is cached; the slot of the last
committed token is written during the round; the draft runs one extra
step so its last proposal's slot is written too; stale slots past the
committed point (rejected proposals, ragged prompt padding) are
overwritten before any query's mask admits them. Positions are per row
(``committed`` [B]).

The JAX ``while_loop`` is a Python loop here, and its condition (some row
still decoding) is read on the host once per round. The JAX ``key``
becomes a ``torch.Generator``.

The continuous-batching API that ``serving/batcher.py`` drives is here
too: :class:`SpecBatchState` (a dataclass of tensors: the batch's tokens,
per-slot clocks and both models' caches), :func:`spec_batch_alloc`,
:func:`spec_join_many` (prefill a wave of sessions into free slots, the
prefill through ``flash_fwd`` on the card), :func:`spec_round` (one
speculative round over the whole batch; :func:`speculative_generate`
runs the same rounds to the end) and :func:`spec_round_block`
(``k`` rounds, a loop of :func:`spec_round`). The JAX package donates
the state to its jitted calls; here they update it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .transformer import (
    LMConfig,
    _alloc_kv_caches,
    _categorical,
    _chunk_decode,
    _heads,
    _prefill,
    _validate_prompt_lengths,
    _weights,
)


def _accept_and_correct(generator, d, p_d, p_t):
    """The Leviathan accept/reject core. ``d`` [B, g] draft proposals
    drawn from ``p_d`` [B, g, V]; ``p_t`` [B, g+1, V] target
    probabilities at the same positions (row g: the bonus position).
    Proposal j is accepted with probability ``min(1, p_t[j][d_j] /
    p_d[j][d_j])``; ``n`` counts the leading accepts and the correction
    at position n is drawn from the normalized ``max(p_t[n] - p_d[n],
    0)`` (``p_t[g]`` at the bonus position). Returns (n [B], commit_row
    [B, g+1]): ``d[j]`` for j < n, the correction at j = n."""
    b, g = d.shape
    rows = torch.arange(b, device=d.device)
    u = torch.rand((b, g), generator=generator, device=d.device)
    pd_at = torch.gather(p_d, -1, d[..., None])[..., 0]
    pt_at = torch.gather(p_t[:, :g], -1, d[..., None])[..., 0]
    accept = u * torch.clamp_min(pd_at, 1e-30) < pt_at  # u < pt / pd
    n = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    p_d_ext = torch.cat([p_d, torch.zeros_like(p_t[:, :1])], dim=1)
    resid = torch.clamp_min(p_t[rows, n] - p_d_ext[rows, n], 0.0)
    mass = resid.sum(-1, keepdim=True)
    # mass == 0 only when p_t == p_d, where nothing is rejected
    resid = torch.where(mass > 1e-12, resid, p_t[rows, n])
    correction = _categorical(torch.log(torch.clamp_min(resid, 1e-30)), generator)
    j_idx = torch.arange(g + 1, device=d.device)[None, :]
    commit_row = torch.where(j_idx < n[:, None], F.pad(d, (0, 1)), correction[:, None])
    return n, commit_row


def speculative_generate(target_params, target_cfg: LMConfig, draft_params, draft_cfg: LMConfig,
                         prompt, steps: int, *, gamma: int = 4, prompt_lengths=None,
                         eos_id: "int | None" = None, temperature=None,
                         generator: "torch.Generator | None" = None, return_stats: bool = False,
                         mesh=None):
    """Speculative decoding that provably matches decoding the target
    directly: returns the tokens [B, P + steps] (int64), and with
    ``return_stats`` also ``{"rounds", "target_passes",
    "accepted_frac"}`` (the share of proposals accepted and committed
    while their row was live).

    ``temperature=None`` (or 0) is greedy: token for token the target's
    greedy ``lm_generate``. ``temperature > 0`` samples (the draft
    samples its proposals, :func:`_accept_and_correct` keeps the
    target's distribution) and needs ``generator``. ``prompt_lengths``
    and ``eos_id`` as in ``lm_generate``. A target placed by
    ``shard_lm_params`` runs on ``mesh`` (default: its own) with
    Megatron's blocks, every rank of the server row calling this alike;
    the draft stays whole on each."""
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError(f"vocab mismatch: target {target_cfg.vocab} vs draft {draft_cfg.vocab}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if eos_id is not None and not 0 <= eos_id < target_cfg.vocab:
        raise ValueError(f"eos_id must be in [0, vocab={target_cfg.vocab}), got {eos_id}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    greedy = temperature is None or temperature == 0
    if not greedy:
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    device = target_params["emb"].device
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    if prompt_lengths is None:
        lengths = torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int64, device=device)
    else:
        lengths = _validate_prompt_lengths(prompt_lengths, prompt)
    out, stats = _speculate(_weights(target_params, target_cfg, mesh), target_cfg,
                            _weights(draft_params, draft_cfg), draft_cfg, prompt, lengths, steps,
                            gamma, None if greedy else float(temperature), eos_id, generator)
    return (out, stats) if return_stats else out


def _speculate(tw, tcfg, dw, dcfg, prompt, lengths, steps, gamma, temperature, eos_id,
               generator):
    """The prefill and first token, then :func:`spec_round` until every
    row has spent its budget or hit ``eos_id``."""
    b, p_len = prompt.shape
    dev = prompt.device
    limit = lengths + steps  # [B] per-row budget
    total = p_len + steps + gamma + 1  # a round overshoots by gamma + 1 trash slot
    tk, tv = _alloc_kv_caches(tcfg, b, total, dev, _heads(tw, tcfg).kv_heads)
    dk, dv = _alloc_kv_caches(dcfg, b, total, dev)
    t_logits = _prefill(tw, tcfg, prompt, tk, tv)
    _prefill(dw, dcfg, prompt, dk, dv)
    rows = torch.arange(b, device=dev)
    col = torch.arange(p_len, device=dev)
    toks = torch.zeros((b, total), dtype=torch.int64, device=dev)
    toks[:, :p_len] = torch.where(col[None, :] < lengths[:, None], prompt, 0)
    last = t_logits[rows, lengths - 1]
    if temperature is None:
        first = torch.argmax(last, -1)
    else:
        first = _categorical(last / temperature, generator)
    toks[rows, lengths] = first
    eos = torch.full((b,), -1 if eos_id is None else eos_id, dtype=torch.int64, device=dev)
    # a first token that IS the stop token finishes the row
    committed = torch.where(first == eos, limit, lengths + 1)
    state = SpecBatchState(toks=toks, committed=committed, limit=limit, eos=eos,
                           tk=tk, tv=tv, dk=dk, dv=dv)
    rounds = 0
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    prop = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((state.committed < limit).any()):
        a, p = spec_round(tw, dw, state, tcfg=tcfg, dcfg=dcfg, gamma=gamma,
                          temperature=temperature, generator=generator)
        acc += a
        prop += p
        rounds += 1
    stats: Dict[str, float] = {"rounds": rounds, "target_passes": rounds,
                               "accepted_frac": float(acc) / max(int(prop), 1)}
    return toks[:, :p_len + steps], stats


# -- continuous batching: the round-stepped API ---------------------------
#
# One speculative-decode state machine for many sessions: _speculate runs
# spec_round to the end over one batch of prompts; the batcher steps it
# itself, so the host decides between rounds when to step, who joins a
# free slot and who retires. The batcher runs greedy only: its contract is
# token parity with each session's own greedy speculative_generate run,
# which goes through the same spec_round.
#
# A free or retired slot has committed == limit, so its commit is capped
# at zero tokens (everything lands in the trash slot) and its toks row
# never changes after retirement. Its cache rows keep receiving garbage
# writes while idle; they obey the overwrite-before-admissible invariant
# (a join rewrites the slot's whole cache rows), so a rejoin is exact.
# Per-slot eos is -1 for "no stop token": one round serves mixed sessions.


@dataclasses.dataclass
class SpecBatchState:
    """The state of one continuous decode batch, on the models' device:
    ``toks [S, cap]`` the committed tokens (int64), ``committed``,
    ``limit`` and ``eos`` [S] the per-slot clocks (a free slot has
    ``committed == limit``), and both models' KV caches at batch
    capacity. ``cap`` is ``max_prompt + max_new + gamma + 1``
    (speculation overshoot + the trash slot)."""

    toks: torch.Tensor
    committed: torch.Tensor
    limit: torch.Tensor
    eos: torch.Tensor
    tk: Tuple
    tv: Tuple
    dk: Tuple
    dv: Tuple


def spec_batch_alloc(tcfg: LMConfig, dcfg: LMConfig, slots: int, capacity: int,
                     device) -> SpecBatchState:
    """A fresh all-slots-free batch. ``committed = limit = 1`` (not 0),
    so an idle slot's round input ``toks[s, committed - 1]`` is a valid
    position."""
    if tcfg.vocab != dcfg.vocab:
        raise ValueError(f"vocab mismatch: target {tcfg.vocab} vs draft {dcfg.vocab} "
                         "— the models must share a tokenizer")
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    tk, tv = _alloc_kv_caches(tcfg, slots, capacity, device)
    dk, dv = _alloc_kv_caches(dcfg, slots, capacity, device)
    ones = torch.ones((slots,), dtype=torch.int64, device=device)
    return SpecBatchState(toks=torch.zeros((slots, capacity), dtype=torch.int64, device=device),
                          committed=ones.clone(), limit=ones.clone(),
                          eos=torch.full((slots,), -1, dtype=torch.int64, device=device),
                          tk=tk, tv=tv, dk=dk, dv=dv)


def _scatter_rows(full, rows, slots) -> None:
    """Cache rows ``rows`` [L, R, ...] into ``full`` [L, S, ...] at
    ``slots`` [R], data and (int8) scale alike, in place."""
    for f, r in zip(full, rows):
        if f is not None:
            f[:, slots] = r


def spec_join_many(tw, dw, state: SpecBatchState, prompts, lengths, steps, eos_ids, slots, *,
                   tcfg: LMConfig, dcfg: LMConfig) -> None:
    """Admit R sessions into ``slots`` [R] at a round boundary: prefill
    both models on ``prompts [R, P]`` (right-padded), write the rows'
    whole caches into the batch caches, commit each row's first target
    token (greedy). ``lengths``, ``steps`` and ``eos_ids`` (-1: none) are
    [R]. ``tw``/``dw``: the weights as ``_weights`` casts them."""
    cap = state.toks.shape[1]
    r, p_len = prompts.shape
    dev = state.toks.device
    rtk, rtv = _alloc_kv_caches(tcfg, r, cap, dev)
    rdk, rdv = _alloc_kv_caches(dcfg, r, cap, dev)
    t_logits = _prefill(tw, tcfg, prompts, rtk, rtv)
    _prefill(dw, dcfg, prompts, rdk, rdv)
    for full, rows in ((state.tk, rtk), (state.tv, rtv), (state.dk, rdk), (state.dv, rdv)):
        _scatter_rows(full, rows, slots)
    col = torch.arange(p_len, device=dev)[None, :]
    row_toks = torch.zeros((r, cap), dtype=torch.int64, device=dev)
    row_toks[:, :p_len] = torch.where(col < lengths[:, None], prompts, 0)
    rows = torch.arange(r, device=dev)
    first = torch.argmax(t_logits[rows, lengths - 1], -1)
    row_toks[rows, lengths] = first
    limit_new = lengths + steps
    # a first token that IS the stop token finishes the session now
    committed_new = torch.where(first == eos_ids, limit_new, lengths + 1)
    state.toks[slots] = row_toks
    state.committed[slots] = committed_new
    state.limit[slots] = limit_new
    state.eos[slots] = eos_ids


def spec_round(tw, dw, state: SpecBatchState, *, tcfg: LMConfig, dcfg: LMConfig, gamma: int,
               temperature: "float | None" = None, generator: "torch.Generator | None" = None):
    """One speculative round over the whole batch, with per-slot eos, in
    place: greedy, or sampled at ``temperature`` from ``generator``
    (:func:`_accept_and_correct`). A finished row re-processes its last
    slot and commits nothing. Returns ``(accepted, proposed)`` as 0-dim
    tensors, counting live slots and accepted-AND-committed proposals
    only."""
    toks, committed, limit, eos = state.toks, state.committed, state.limit, state.eos
    b, total = toks.shape
    dev = toks.device
    trash = total - 1
    rows = torch.arange(b, device=dev)
    live = committed < limit
    x0 = toks[rows, committed - 1]  # the last committed token
    d_toks, d_probs = [], []
    cur = x0
    for j in range(gamma):  # the draft: gamma sequential proposals
        dl = _chunk_decode(dw, dcfg, cur[:, None], state.dk, state.dv, committed - 1 + j)[:, 0]
        if temperature is None:
            cur = torch.argmax(dl, -1)
        else:
            z = dl / temperature
            cur = _categorical(z, generator)
            d_probs.append(torch.softmax(z, -1))
        d_toks.append(cur)
    # one extra draft step writes d_gamma's own slot (its logits unused)
    _chunk_decode(dw, dcfg, cur[:, None], state.dk, state.dv, committed - 1 + gamma)
    d = torch.stack(d_toks, 1)  # [B, gamma]
    # the target: ONE (gamma+1)-chunk verify over [x0, d1..dg]
    tl = _chunk_decode(tw, tcfg, torch.cat([x0[:, None], d], 1), state.tk, state.tv,
                       committed - 1)
    j_idx = torch.arange(gamma + 1, device=dev)[None, :]
    if temperature is None:
        tpred = torch.argmax(tl, -1)  # [B, gamma+1]
        agree = d == tpred[:, :gamma]
        n = torch.cumprod(agree.to(torch.int64), 1).sum(1)
        commit_row = torch.where(j_idx < n[:, None], F.pad(d, (0, 1)), tpred[rows, n][:, None])
    else:
        n, commit_row = _accept_and_correct(generator, d, torch.stack(d_probs, 1),
                                            torch.softmax(tl / temperature, -1))
    # capped commit: a finished row re-processes its last slot
    n_eff = torch.minimum(n + 1, limit - committed)
    # clamp at the first stop token inside the commit (eos -1: none); the row freezes
    is_eos = (commit_row == eos[:, None]) & (j_idx < n_eff[:, None])
    first_eos = torch.where(is_eos, j_idx, gamma + 1).amin(1)
    n_eff = torch.minimum(n_eff, first_eos + 1)
    dest = torch.where(j_idx < n_eff[:, None], committed[:, None] + j_idx, trash)
    toks[rows[:, None], dest] = commit_row
    new_committed = torch.where(first_eos <= gamma, limit, committed + n_eff)
    state.committed.copy_(new_committed)
    acc = torch.where(live, torch.minimum(n, n_eff), 0).sum()
    prop = live.sum() * gamma
    return acc, prop


def spec_round_block(tw, dw, state: SpecBatchState, k: int, *, tcfg: LMConfig, dcfg: LMConfig,
                     gamma: int):
    """``k`` rounds back to back (the JAX package fuses them into one
    dispatch; here they are ``k`` calls of :func:`spec_round` with no
    host read in between). Returns the summed ``(accepted, proposed)``."""
    dev = state.toks.device
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    prop = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(k):
        a, p = spec_round(tw, dw, state, tcfg=tcfg, dcfg=dcfg, gamma=gamma)
        acc += a
        prop += p
    return acc, prop
