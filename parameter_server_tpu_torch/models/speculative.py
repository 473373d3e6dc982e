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
becomes a ``torch.Generator``. Not here yet: the continuous-batching
state (``SpecBatchState``, ``_spec_join*``, ``_round_core``) that
``serving/batcher.py`` drives.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .transformer import (
    LMConfig,
    _alloc_kv_caches,
    _categorical,
    _chunk_decode,
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
                         generator: "torch.Generator | None" = None, return_stats: bool = False):
    """Speculative decoding that provably matches decoding the target
    directly: returns the tokens [B, P + steps] (int64), and with
    ``return_stats`` also ``{"rounds", "target_passes",
    "accepted_frac"}`` (the share of proposals accepted and committed
    while their row was live).

    ``temperature=None`` (or 0) is greedy: token for token the target's
    greedy ``lm_generate``. ``temperature > 0`` samples (the draft
    samples its proposals, :func:`_accept_and_correct` keeps the
    target's distribution) and needs ``generator``. ``prompt_lengths``
    and ``eos_id`` as in ``lm_generate``."""
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
    out, stats = _speculate(_weights(target_params, target_cfg), target_cfg,
                            _weights(draft_params, draft_cfg), draft_cfg, prompt, lengths, steps,
                            gamma, None if greedy else float(temperature), eos_id, generator)
    return (out, stats) if return_stats else out


def _speculate(tw, tcfg, dw, dcfg, prompt, lengths, steps, gamma, temperature, eos_id,
               generator):
    b, p_len = prompt.shape
    dev = prompt.device
    greedy = temperature is None
    limit = lengths + steps  # [B] per-row budget
    total = p_len + steps + gamma + 1  # a round overshoots by gamma + 1 trash slot
    trash = total - 1  # masked-commit writes land here and are never read
    tk, tv = _alloc_kv_caches(tcfg, b, total, dev)
    dk, dv = _alloc_kv_caches(dcfg, b, total, dev)
    t_logits = _prefill(tw, tcfg, prompt, tk, tv)
    _prefill(dw, dcfg, prompt, dk, dv)
    rows = torch.arange(b, device=dev)
    col = torch.arange(p_len, device=dev)
    toks = torch.zeros((b, total), dtype=torch.int64, device=dev)
    toks[:, :p_len] = torch.where(col[None, :] < lengths[:, None], prompt, 0)
    last = t_logits[rows, lengths - 1]
    first = torch.argmax(last, -1) if greedy else _categorical(last / temperature, generator)
    toks[rows, lengths] = first
    committed = lengths + 1
    if eos_id is not None:  # a first token that IS the stop token finishes the row
        committed = torch.where(first == eos_id, limit, committed)
    j_idx = torch.arange(gamma + 1, device=dev)[None, :]
    rounds = 0
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    prop = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((committed < limit).any()):
        live = committed < limit
        x0 = toks[rows, committed - 1]  # the last committed token
        d_toks, d_probs = [], []
        cur = x0
        for j in range(gamma):  # the draft: gamma sequential proposals
            dl = _chunk_decode(dw, dcfg, cur[:, None], dk, dv, committed - 1 + j)[:, 0]
            if greedy:
                cur = torch.argmax(dl, -1)
            else:
                z = dl / temperature
                cur = _categorical(z, generator)
                d_probs.append(torch.softmax(z, -1))
            d_toks.append(cur)
        # one extra draft step writes d_gamma's own slot (its logits unused)
        _chunk_decode(dw, dcfg, cur[:, None], dk, dv, committed - 1 + gamma)
        d = torch.stack(d_toks, 1)  # [B, gamma]
        # the target: ONE (gamma+1)-chunk verify over [x0, d1..dg]
        tl = _chunk_decode(tw, tcfg, torch.cat([x0[:, None], d], 1), tk, tv, committed - 1)
        if greedy:
            tpred = torch.argmax(tl, -1)  # [B, gamma+1]
            agree = d == tpred[:, :gamma]
            n = torch.cumprod(agree.to(torch.int64), 1).sum(1)
            commit_row = torch.where(j_idx < n[:, None], F.pad(d, (0, 1)),
                                     tpred[rows, n][:, None])
        else:
            n, commit_row = _accept_and_correct(generator, d, torch.stack(d_probs, 1),
                                                torch.softmax(tl / temperature, -1))
        # capped commit: a finished row re-processes its last slot
        n_eff = torch.minimum(n + 1, limit - committed)
        if eos_id is not None:
            # clamp at the first stop token inside the commit; the row freezes
            is_eos = (commit_row == eos_id) & (j_idx < n_eff[:, None])
            first_eos = torch.where(is_eos, j_idx, gamma + 1).amin(1)
            n_eff = torch.minimum(n_eff, first_eos + 1)
        dest = torch.where(j_idx < n_eff[:, None], committed[:, None] + j_idx, trash)
        toks[rows[:, None], dest] = commit_row
        committed = committed + n_eff
        if eos_id is not None:
            committed = torch.where(first_eos <= gamma, limit, committed)
        # only live rows, and only accepted-AND-committed proposals, count
        acc += torch.where(live, torch.minimum(n, n_eff), 0).sum()
        prop += live.sum() * gamma
        rounds += 1
    stats: Dict[str, float] = {"rounds": rounds, "target_passes": rounds,
                               "accepted_frac": float(acc) / max(int(prop), 1)}
    return toks[:, :p_len + steps], stats
