"""Continuous batching for the decode lane (iteration-level scheduling
over ONE speculative-decode state).

Counterpart of ``parameter_server_tpu/serving/batcher.py``. Concurrent
sessions share one :class:`~..models.speculative.SpecBatchState` on the
card, joining at ROUND boundaries into free batch slots and retiring
between rounds without stalling the rest: the target model's verify pass
reads its weights once per round for the whole batch instead of once per
session.

Slot lifecycle:

    free ──admit()── prefill+join (one spec_join_many per WAVE)
      ▲                   │
      │                   ▼
    retire ◄──────── live rounds (spec_round, whole batch)
    (committed >= limit, or EOS commit: slot freed between rounds)

Threading contract: the batcher is SINGLE-OWNER — exactly one scheduler
thread (the frontend's decode worker) may call ``admit``/``step``; the
owner is recorded on first use and enforced. :meth:`stats` is the one
cross-thread read, of mirror counters behind ``_lock``.

Correctness contract: GREEDY token parity — every session's output is
token-for-token identical to its own ``speculative_generate`` run,
whoever shared the batch and whenever they joined or left.

The occupancy, join, round and retirement counts go to the telemetry
registry (``ps_serve_batch_*``) as well as to :meth:`stats`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.speculative import (
    SpecBatchState,
    spec_batch_alloc,
    spec_join_many,
    spec_round,
    spec_round_block,
)
from ..models.transformer import _weights


@dataclasses.dataclass
class BatcherConfig:
    """Capacity knobs; they size the batch state.

    ``slots`` bounds concurrent sessions. ``max_prompt`` is the fixed
    prefill width every joining prompt is right-padded to; ``max_new``
    bounds per-session ``steps``; ``gamma`` is the shared speculation
    depth. ``max_block`` caps the rounds :meth:`ContinuousBatcher.
    step_block` runs between two retirement checks (a throughput knob:
    blocks never overshoot a retirement, but defer joins to block
    boundaries)."""

    slots: int = 8
    max_prompt: int = 64
    max_new: int = 64
    gamma: int = 4
    max_block: int = 8

    def capacity(self) -> int:
        # speculation can overshoot a row's budget by gamma, plus the
        # trash slot masked commits land in
        return self.max_prompt + self.max_new + self.gamma + 1


class _Session:
    """One prompt row resident in one slot."""

    __slots__ = ("handle", "row_idx", "slot", "length", "steps", "width", "limit")

    def __init__(self, handle, row_idx, slot, length, steps, width):
        self.handle = handle
        self.row_idx = row_idx
        self.slot = slot
        self.length = length
        self.steps = steps
        self.width = width  # the request's ORIGINAL prompt width
        self.limit = length + steps  # host mirror of the device clock


class BatchHandle:
    """One admitted DecodeRequest: its rows decode as independent
    sessions; the handle completes (is returned from :meth:`step`) when
    the LAST row retires, carrying the reassembled ``[B, P+steps]``
    output (int64 tokens) in original row order."""

    __slots__ = ("req", "context", "rows_left", "out")

    def __init__(self, req, context, n_rows: int, width: int):
        self.req = req
        self.context = context  # caller cookie (the frontend's Ticket)
        self.rows_left = n_rows
        self.out = np.zeros((n_rows, width + int(req.steps)), np.int64)


# owner-thread: scheduler
class ContinuousBatcher:
    """ONE running speculative decode shared by concurrent sessions.

    Greedy only (the parity contract); both configs must share a vocab.
    The state lives on the target parameters' device."""

    def __init__(self, target_params, target_cfg, draft_params, draft_cfg,
                 config: Optional[BatcherConfig] = None):
        self.cfg = config or BatcherConfig()
        if self.cfg.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.cfg.gamma}")
        if self.cfg.max_prompt < 1 or self.cfg.max_new < 1:
            raise ValueError("max_prompt and max_new must be >= 1")
        self.tparams = target_params
        self.tcfg = target_cfg
        self.dparams = draft_params
        self.dcfg = draft_cfg
        self.device = target_params["emb"].device
        # the weights cast to the compute dtype once (a no-op in float32)
        self._tw = _weights(target_params, target_cfg)
        self._dw = _weights(draft_params, draft_cfg)
        # spec_batch_alloc validates the shared-vocab contract
        self.state: SpecBatchState = spec_batch_alloc(
            target_cfg, draft_cfg, self.cfg.slots, self.cfg.capacity(), self.device)
        # scheduler-thread-only state (single owner, enforced by _check_owner)
        self._free: List[int] = list(range(self.cfg.slots))
        self._sessions: dict = {}  # slot -> _Session
        self._owner: Optional[int] = None
        self._lock = threading.Lock()
        # cross-thread stats mirrors (stats() reads them off-thread)
        self._occupancy = 0  # guarded-by: _lock
        self._joins = 0  # guarded-by: _lock
        self._leaves = 0  # guarded-by: _lock
        self._rounds = 0  # guarded-by: _lock
        self._retired = 0  # guarded-by: _lock
        self._accepted = 0  # guarded-by: _lock
        self._proposed = 0  # guarded-by: _lock
        from ..telemetry.instruments import cached_serve_instruments

        self._tel = cached_serve_instruments

    # -- the single-owner rule --

    def _check_owner(self) -> None:
        me = threading.get_ident()
        if self._owner is None:
            self._owner = me
        elif self._owner != me:
            raise RuntimeError(
                "ContinuousBatcher is single-owner: admit/step must run on the one scheduler "
                "thread that first used it"
            )

    # -- scheduler-thread API --

    def free_slots(self) -> int:
        self._check_owner()
        return len(self._free)

    def active_sessions(self) -> int:
        self._check_owner()
        return len(self._sessions)

    def _kw(self) -> dict:
        return dict(tcfg=self.tcfg, dcfg=self.dcfg)

    def warmup(self) -> None:
        """Run everything once ahead of traffic (on the card: the kernel
        builds, cuBLAS's handles and the caching allocator): a round, a
        one-round block, and a join of each power-of-two wave size. The
        warmup joins write dead rows (steps 1 with the first token
        already committed, so committed == limit)."""
        self._check_owner()
        with torch.no_grad():
            spec_round(self._tw, self._dw, self.state, gamma=self.cfg.gamma, **self._kw())
            spec_round_block(self._tw, self._dw, self.state, 1, gamma=self.cfg.gamma,
                             **self._kw())
            if self._sessions:
                return  # joins write slot 0; only safe on an empty batch
            r = 1
            while r <= self.cfg.slots:
                ones = torch.ones((r,), dtype=torch.int64, device=self.device)
                spec_join_many(self._tw, self._dw, self.state,
                               torch.zeros((r, self.cfg.max_prompt), dtype=torch.int64,
                                           device=self.device),
                               ones, ones, torch.full((r,), -1, dtype=torch.int64,
                                                      device=self.device),
                               torch.zeros((r,), dtype=torch.int64, device=self.device),
                               **self._kw())
                r *= 2

    def validate(self, req) -> Tuple[np.ndarray, np.ndarray]:
        """Shape/budget checks for one DecodeRequest (raises ValueError
        before any slot is consumed). Returns ``(prompt [B, P], lengths
        [B])``."""
        prompt = np.asarray(req.prompt.cpu() if isinstance(req.prompt, torch.Tensor)
                            else req.prompt).astype(np.int64)
        if prompt.ndim != 2 or prompt.shape[1] < 1:
            raise ValueError(f"prompt must be [B, P>=1], got {prompt.shape}")
        b, p = prompt.shape
        if p > self.cfg.max_prompt:
            raise ValueError(f"prompt width {p} > batcher max_prompt {self.cfg.max_prompt}")
        if b > self.cfg.slots:
            raise ValueError(f"request batch {b} can never fit in {self.cfg.slots} slots")
        steps = int(req.steps)
        if not 1 <= steps <= self.cfg.max_new:
            raise ValueError(f"steps must be in [1, max_new={self.cfg.max_new}], got {steps}")
        if req.eos_id is not None and not 0 <= int(req.eos_id) < self.tcfg.vocab:
            raise ValueError(f"eos_id must be in [0, vocab={self.tcfg.vocab}), got {req.eos_id}")
        if req.prompt_lengths is None:
            lengths = np.full(b, p, np.int64)
        else:
            lengths = np.asarray(req.prompt_lengths, np.int64).ravel()
            if lengths.shape != (b,):
                raise ValueError(f"prompt_lengths must be [B={b}], got {lengths.shape}")
            if (lengths < 1).any() or (lengths > p).any():
                raise ValueError(f"prompt_lengths must be in [1, {p}]")
        return prompt, lengths

    def admit(self, req, context=None) -> BatchHandle:
        """Join every row of ``req`` into free slots at this round
        boundary. Raises ValueError on a malformed request and
        RuntimeError when the batch lacks the slots."""
        return self.admit_many([(req, context)])[0]

    def admit_many(self, reqs) -> List[BatchHandle]:
        """Join a WAVE of requests — every row of every ``(req,
        context)`` pair — in ONE :func:`spec_join_many` call. All
        requests are validated before any slot is consumed; the whole
        wave must fit the free slots or RuntimeError."""
        self._check_owner()
        validated = [(req, ctx) + self.validate(req) for req, ctx in reqs]
        total = sum(prompt.shape[0] for _, _, prompt, _ in validated)
        if total == 0:
            return []
        if total > len(self._free):
            raise RuntimeError(f"batch full: {total} rows, {len(self._free)} free slots")
        handles: List[BatchHandle] = []
        padded = np.zeros((total, self.cfg.max_prompt), np.int64)
        len_v, steps_v, eos_v, slots_v = (np.zeros(total, np.int64) for _ in range(4))
        row = 0
        for req, ctx, prompt, lengths in validated:
            b, width = prompt.shape
            handle = BatchHandle(req, ctx, b, width)
            handles.append(handle)
            eos = -1 if req.eos_id is None else int(req.eos_id)
            steps = int(req.steps)
            for r in range(b):
                slot = self._free.pop()
                padded[row, :width] = prompt[r]
                len_v[row] = lengths[r]
                steps_v[row] = steps
                eos_v[row] = eos
                slots_v[row] = slot
                self._sessions[slot] = _Session(handle, r, slot, int(lengths[r]), steps, width)
                row += 1
        dev = self.device
        with torch.no_grad():
            spec_join_many(self._tw, self._dw, self.state, torch.from_numpy(padded).to(dev),
                           torch.from_numpy(len_v).to(dev), torch.from_numpy(steps_v).to(dev),
                           torch.from_numpy(eos_v).to(dev), torch.from_numpy(slots_v).to(dev),
                           **self._kw())
        occ = len(self._sessions)
        with self._lock:
            self._joins += total
            self._occupancy = occ
        tel = self._tel()
        if tel is not None:
            tel["batch_joins"].inc(total)
            tel["batch_occupancy"].set(occ)
        return handles

    def step(self) -> List[BatchHandle]:
        """Advance every resident session by one speculative round,
        retire finished slots, and return the handles whose LAST row just
        completed. No-op (empty list) on an empty batch."""
        self._check_owner()
        if not self._sessions:
            return []
        with torch.no_grad():
            acc, prop = spec_round(self._tw, self._dw, self.state, gamma=self.cfg.gamma,
                                   **self._kw())
        return self._retire(1, acc, prop)

    def step_block(self) -> List[BatchHandle]:
        """Advance by UP TO ``cfg.max_block`` rounds, then retire. The
        block is bounded so no row can reach its limit inside it (a
        round commits at most gamma+1 tokens), which keeps retirement
        latency that of single-round stepping; a resident eos-armed
        session can finish early, so its presence drops the block to one
        round."""
        self._check_owner()
        if not self._sessions:
            return []
        k = self.cfg.max_block
        if k > 1 and not any(s.handle.req.eos_id is not None for s in self._sessions.values()):
            committed = self.state.committed.cpu().numpy()
            g1 = self.cfg.gamma + 1
            shortest = min(-(-(s.limit - int(committed[s.slot])) // g1)
                           for s in self._sessions.values())
            k = max(1, min(k, shortest))
        else:
            k = 1
        if k == 1:
            return self.step()
        with torch.no_grad():
            acc, prop = spec_round_block(self._tw, self._dw, self.state, k,
                                         gamma=self.cfg.gamma, **self._kw())
        return self._retire(k, acc, prop)

    def _retire(self, n_rounds: int, acc, prop) -> List[BatchHandle]:
        """Scan for finished rows after a round (or block), free their
        slots, and fold the round stats into the mirrors."""
        committed = self.state.committed.cpu().numpy()
        finished: List[BatchHandle] = []
        n_retired = 0
        done = [s for s in list(self._sessions) if committed[s] >= self._sessions[s].limit]
        toks = self.state.toks[done].cpu().numpy() if done else None
        for i, slot in enumerate(done):
            sess = self._sessions[slot]
            # a finished slot's toks row is frozen (capped commits land in
            # the trash slot), so it reads the same whenever it is read
            sess.handle.out[sess.row_idx] = toks[i, : sess.width + sess.steps]
            sess.handle.rows_left -= 1
            if sess.handle.rows_left == 0:
                finished.append(sess.handle)
            del self._sessions[slot]
            self._free.append(slot)
            n_retired += 1
        occ = len(self._sessions)
        acc, prop = int(acc), int(prop)
        with self._lock:
            self._rounds += n_rounds
            self._retired += n_retired
            self._leaves += n_retired
            self._occupancy = occ
            self._accepted += acc
            self._proposed += prop
        tel = self._tel()
        if tel is not None:
            tel["batch_rounds"].inc(n_rounds)
            if n_retired:
                tel["batch_retired"].inc(n_retired)
                tel["batch_leaves"].inc(n_retired)
            tel["batch_occupancy"].set(occ)
        return finished

    # -- cross-thread introspection --

    def stats(self) -> dict:
        with self._lock:
            acc, prop = self._accepted, self._proposed
            return {
                "slots": self.cfg.slots,
                "occupancy": self._occupancy,
                "joins": self._joins,
                "leaves": self._leaves,
                "rounds": self._rounds,
                "retired": self._retired,
                "accepted_frac": acc / prop if prop else 0.0,
            }
