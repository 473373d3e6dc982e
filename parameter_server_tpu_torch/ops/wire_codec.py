"""Decode ops of the encoded host-to-device wires.

Counterpart of ``parameter_server_tpu/ops/wire_codec.py``. The prep
stage ships encoded batch buffers (``learner/wire.py``) and the step
rebuilds the raw arrays with these ops on the device it runs on, so only
the encoded bytes cross PCIe. Each op is the exact inverse of its host
encoder over the domain the encoder checks batch by batch, so a decoded
batch equals the raw one, dtype for dtype.

uint32 words are held in int64 (``utils/bitpack.words_i64``); integer
sums are exact, so a decode gives the same values on the card and on
the CPU.
"""

from __future__ import annotations

import torch

from ..filter.fixing_float import dequantize_torch
from ..utils.bitpack import unpack_bits, unpack_sign_bits


def _u16(t: torch.Tensor) -> torch.Tensor:
    """uint8 or uint16 codes (a uint16 array may travel as its int16
    view) -> int32 values."""
    if t.dtype in (torch.uint16, torch.int16):
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def decode_u24(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] little-endian -> int32 [...]."""
    s = b.to(torch.int32)
    return s[..., 0] | (s[..., 1] << 8) | (s[..., 2] << 16)


def decode_bitstream(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Word stream -> int32 [n] of ``bits`` each."""
    return unpack_bits(words, n, bits)


def decode_sign_labels(y_bits: torch.Tensor, count, rows: int) -> torch.Tensor:
    """Sign bits -> float32 ±1 [rows], exactly 0.0 on padding rows."""
    y = unpack_sign_bits(y_bits, rows)
    return torch.where(_arange(rows, y) < count, y, 0.0)


def decode_mask(count, rows: int) -> torch.Tensor:
    """Live-row count -> the float32 {1, 0} row mask."""
    return (_arange(rows, torch.as_tensor(count)) < count).to(torch.float32)


def decode_row_ids(row_counts: torch.Tensor, nnz, nnz_pad: int) -> torch.Tensor:
    """Features a row -> int32 [nnz_pad] COO row ids (``repeat(arange(R),
    counts)``), zero past ``nnz``: a +1 at each row's start, then an
    inclusive cumsum (an empty row's start stacks onto the next one's).
    Integer adds, so the order of the scatter does not matter."""
    starts = torch.cumsum(_u16(row_counts).to(torch.int64), 0)[:-1]
    bumps = torch.zeros(nnz_pad + 1, dtype=torch.int32, device=row_counts.device)
    bumps.index_add_(0, torch.clamp(starts, max=nnz_pad),
                     torch.ones_like(starts, dtype=torch.int32))
    ids = torch.cumsum(bumps[:nnz_pad], 0, dtype=torch.int32)
    return torch.where(_arange(nnz_pad, ids) < nnz, ids, 0)


def decode_sorted_deltas(deltas: torch.Tensor, n_uniq, sentinel: int) -> torch.Tensor:
    """u16 gap stream -> sorted int32 slots, ``sentinel`` past ``n_uniq``."""
    s = torch.cumsum(_u16(deltas), 0, dtype=torch.int32)
    return torch.where(_arange(deltas.shape[0], s) < n_uniq, s, sentinel)


def decode_binary_vals(nnz, nnz_pad: int) -> torch.Tensor:
    """nnz -> the value array of a binary batch: 1.0 live, 0.0 padding."""
    return decode_mask(nnz, nnz_pad)


def decode_fixed_point(q: torch.Tensor, lo, hi, num_bytes: int) -> torch.Tensor:
    """u8/u16 codes with a scalar (lo, hi) -> float32."""
    return dequantize_torch(_u16(q), lo, hi, num_bytes)


def decode_bf16(v: torch.Tensor) -> torch.Tensor:
    """bfloat16 values (or their int16 view) -> float32, exactly."""
    if v.dtype != torch.bfloat16:
        v = v.view(torch.bfloat16)
    return v.to(torch.float32)


def decode_stream_slots(raw_words, code_words, table_words, lane_starts, *, rows: int,
                        lanes: int, dict_lanes: tuple, code_bits: int, dict_pad: int,
                        raw_bits: int, order: torch.Tensor = None) -> torch.Tensor:
    """The lane-dictionary wire -> int32 [rows, lanes] ELL slots.

    A dictionary lane decodes as ``table[lane_start + code]``, a raw
    lane from the raw bitstream; the columns then go back to lane order
    (``order``: :func:`lane_order`'s tensor, which a step makes once;
    made here if None). Codes of padding rows stay inside the table (the
    clamp), whose dead entries are packed zeros; the step's row mask
    gates those rows."""
    n_dict = len(dict_lanes)
    n_raw = lanes - n_dict
    parts = []
    if n_dict:
        table = unpack_bits(table_words, dict_pad, raw_bits)
        codes = unpack_bits(code_words, rows * n_dict, code_bits).reshape(rows, n_dict)
        idx = torch.clamp(lane_starts.to(torch.int64)[None, :] + codes, max=dict_pad - 1)
        parts.append(table[idx])
    if n_raw:
        parts.append(unpack_bits(raw_words, rows * n_raw, raw_bits).reshape(rows, n_raw))
    cols = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if order is None:
        order = lane_order(dict_lanes, lanes, cols.device)
    return cols.index_select(1, order)


def lane_order(dict_lanes: tuple, lanes: int, device) -> torch.Tensor:
    """The column of each lane among (dictionary lanes, then raw lanes)."""
    dict_set = frozenset(dict_lanes)
    concat = list(dict_lanes) + [j for j in range(lanes) if j not in dict_set]
    perm = [0] * lanes
    for pos, j in enumerate(concat):
        perm[j] = pos
    return torch.tensor(perm, device=device)
