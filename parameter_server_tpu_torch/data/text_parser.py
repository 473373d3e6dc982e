"""Text format parsers: lines -> ``SparseBatch``.

Counterpart of the pure-Python line path of
``parameter_server_tpu/data/text_parser.py`` (the reference's
``ExampleParser``) for every text format of the reference: libsvm
("label idx:val ..."), criteo (label, 13 integer counts, 26 categorical
tokens, tab-separated), adfea ("line_id 1 label key:group ..."), terafea
("label line_id separator key ...") and the parameter server's own
SPARSE ("label;group idx:val ...;"), SPARSE_BINARY ("label;group key
...;") and DENSE ("label;group val val ...;"). libsvm and criteo go
through the port's native library (``native/psnative.cc``, the same
source as the JAX package's) unless the parser is built with
``use_native=False``; the native and Python parsers give bit-identical
batches. The other formats are Python only, as in the JAX package. An
unknown name, and ``bin``, raise ``ValueError``.
"""

from __future__ import annotations

import ctypes
import re
from typing import List, Optional

import numpy as np

from .. import native
from ..utils.murmur import murmur3_x64_128
from ..utils.sparse import SparseBatch

# per-slot key striping for multi-slot formats
SLOT_SPACE = 1 << 52


def _batch_from_rows(
    labels: List[float],
    row_keys: List[np.ndarray],
    row_vals: Optional[List[np.ndarray]],
    row_slots: Optional[List[np.ndarray]] = None,
) -> SparseBatch:
    n = len(labels)
    counts = np.array([len(k) for k in row_keys], dtype=np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    has_entries = bool(n and indptr[-1])
    indices = np.concatenate(row_keys).astype(np.int64) if has_entries else np.zeros(0, np.int64)
    values = None
    if row_vals is not None:
        values = (
            np.concatenate(row_vals).astype(np.float32) if has_entries
            else np.zeros(0, np.float32)
        )
    slot_ids = None
    if row_slots is not None:
        slot_ids = (
            np.concatenate(row_slots).astype(np.int32) if has_entries
            else np.zeros(0, np.int32)
        )
    return SparseBatch(
        y=np.asarray(labels, dtype=np.float32),
        indptr=indptr,
        indices=indices,
        values=values,
        slot_ids=slot_ids,
    )


_DECFLOAT_RE = re.compile(r"[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?\Z")
# the reference parses numeric tokens through a 64-byte scratch buffer:
# longer tokens are malformed
_MAX_NUM_TOK = 63
# tokens split on space, tab and \r only (not \x0b/\x0c like str.split)
_WS_SPLIT = re.compile(r"[ \t\r]+")
_DECINT_RE = re.compile(r"([+-]?)(\d+)\Z")
_U64_MASK = (1 << 64) - 1


def _decfloat_ok(tok: str) -> bool:
    return len(tok) <= _MAX_NUM_TOK and _DECFLOAT_RE.match(tok) is not None


def _parse_u64(tok: str):
    """strtou64 semantics: optional sign (negation wraps modulo 2^64),
    clamped to ULLONG_MAX before negating, the whole token consumed.
    Returns the uint64 value or None; an empty token is 0."""
    if tok == "":
        return 0
    m = _DECINT_RE.match(tok)
    if not m:
        return None
    # leading zeros carry no magnitude: strip them before the digit-count
    # overflow guard (CPython also caps int() at 4300 digits)
    digits = m.group(2).lstrip("0") or "0"
    mag = _U64_MASK if len(digits) > 20 else min(int(digits), _U64_MASK)
    return (_U64_MASK + 1 - mag) & _U64_MASK if m.group(1) == "-" else mag


def _wrap_i64(x: int) -> int:
    """Fold a Python int into int64 two's-complement range."""
    x &= _U64_MASK
    return x - (1 << 64) if x > (1 << 63) - 1 else x


def _wrap_i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x > (1 << 31) - 1 else x


def parse_libsvm(lines: List[str]) -> SparseBatch:
    """libsvm: every feature in feature-group slot 1. Reference-strict:
    the label and each value must be a full decimal-float token, each
    feature token must hold ':', indices parse as strtou64 and must be
    non-decreasing, and any malformed token drops the whole line. Empty
    sub-tokens are 0 (":val" is feature 0, "idx:" is value 0.0)."""
    labels, keys, vals, slots = [], [], [], []
    for line in lines:
        parts = [t for t in _WS_SPLIT.split(line.rstrip("\n")) if t]
        if not parts or not _decfloat_ok(parts[0]):
            continue
        label = float(parts[0])
        k, v = [], []
        last_idx = 0
        ok = True
        for tok in parts[1:]:
            i, colon, x = tok.partition(":")
            if not colon:
                ok = False
                break
            idx = _parse_u64(i)
            if idx is None or last_idx > idx:
                ok = False
                break
            last_idx = idx
            if x == "":
                val = 0.0
            elif _decfloat_ok(x):
                val = float(x)
            else:
                ok = False
                break
            k.append(_wrap_i64(idx))
            v.append(val)
        if not ok:
            continue
        labels.append(1.0 if label > 0 else -1.0)
        keys.append(np.asarray(k, dtype=np.int64))
        vals.append(np.asarray(v, dtype=np.float32))
        slots.append(np.ones(len(k), dtype=np.int32))
    return _batch_from_rows(labels, keys, vals, slots)


_CRITEO_STRIPE = ((1 << 64) - 1) // 13  # the reference's kMaxKey / 13
_CRITEO_SEED = 512927377
_CRITEO_INT_RE = re.compile(r" *([+-]?)(\d+)\Z")


def parse_criteo(lines: List[str]) -> SparseBatch:
    """criteo: label, 13 integer counts, 26 categorical tokens, all
    binary keys. Integer field i with count c is key ``kMaxKey/13*i + c``
    (an empty field is count 0; a malformed one is skipped); a
    categorical token longer than 4 characters is ``h0 ^ h1`` of its
    MurmurHash3_x64_128 with seed 512927377. Lines with fewer than 40
    fields are dropped. Slots: integer i -> i+1, categorical i -> i+14."""
    labels, keys, slots = [], [], []
    token_keys = {}  # categorical token -> key, for this call's repeats
    for line in lines:
        f = line.rstrip("\n").split("\t")
        if len(f) < 40:
            continue
        lbl_tok = f[0].lstrip(" ")
        if f[0] == "":
            label = 0.0
        elif _decfloat_ok(lbl_tok):
            label = float(lbl_tok)
        else:
            continue
        k, s = [], []
        for i, tok in enumerate(f[1:14]):
            if tok == "":
                k.append((_CRITEO_STRIPE * i) & _U64_MASK)
                s.append(i + 1)
                continue
            m = _CRITEO_INT_RE.match(tok)
            if not m:
                continue
            # strtol: leading zeros carry no magnitude; clamp on overflow,
            # then truncate to int32
            digits = m.group(2).lstrip("0") or "0"
            raw = (1 << 63) if len(digits) > 19 else int(digits)
            if raw > (1 << 63) - 1:
                cnt64 = -(1 << 63) if m.group(1) == "-" else (1 << 63) - 1
            else:
                cnt64 = -raw if m.group(1) == "-" else raw
            k.append((_CRITEO_STRIPE * i + _wrap_i32(cnt64)) & _U64_MASK)
            s.append(i + 1)
        for i, tok in enumerate(f[14:40]):
            if len(tok) > 4:
                key = token_keys.get(tok)
                if key is None:
                    h0, h1 = murmur3_x64_128(tok.encode(), _CRITEO_SEED)
                    key = token_keys[tok] = h0 ^ h1
                k.append(key)
                s.append(i + 14)
        labels.append(1.0 if label > 0 else -1.0)
        keys.append(np.asarray(k, dtype=np.uint64).view(np.int64))
        slots.append(np.asarray(s, dtype=np.int32))
    return _batch_from_rows(labels, keys, None, slots)


def parse_adfea(lines: List[str]) -> SparseBatch:
    """adfea: the tokens, split on spaces and colons, are ``line_id 1
    label key group key group ...`` (the label is the third token).
    Binary; a key is striped by its group (``group * 2^52 + key mod
    (2^52 - 1)``), and the group is its slot."""
    labels, keys, slots = [], [], []
    for line in lines:
        toks = line.replace(":", " ").split()
        if len(toks) < 3:
            continue
        try:
            label = float(toks[2])
        except ValueError:
            continue
        labels.append(1.0 if label > 0 else -1.0)
        k, s = [], []
        pairs = toks[3:]
        for j in range(0, len(pairs) - 1, 2):
            try:
                key = int(pairs[j])
                g = int(pairs[j + 1])
            except ValueError:
                continue
            k.append(_wrap_i64(g * SLOT_SPACE + key % (SLOT_SPACE - 1)))
            s.append(_wrap_i32(g))
        keys.append(np.asarray(k, dtype=np.int64))
        slots.append(np.asarray(s, dtype=np.int32))
    return _batch_from_rows(labels, keys, None, slots)


def parse_terafea(lines: List[str]) -> SparseBatch:
    """terafea: space-separated ``label line_id separator key key ...``.
    Binary; the whole key is the feature (masked to the non-negative
    int64 range) and its top 10 bits (``key >> 54``) are its slot."""
    labels, keys, slots = [], [], []
    for line in lines:
        toks = line.split()
        if len(toks) < 3:
            continue
        try:
            label = float(toks[0])
        except ValueError:
            continue
        labels.append(1.0 if label > 0 else -1.0)
        k, s = [], []
        for tok in toks[3:]:
            try:
                key = int(tok)
            except ValueError:
                continue
            k.append(key & 0x7FFFFFFFFFFFFFFF)
            s.append((key >> 54) & 0x3FF)
        keys.append(np.asarray(k, dtype=np.int64))
        slots.append(np.asarray(s, dtype=np.int32))
    return _batch_from_rows(labels, keys, None, slots)


def parse_ps_sparse(lines: List[str]) -> SparseBatch:
    """SPARSE: "label;grp_id idx:val ...;grp_id ...;" -- keys striped by
    group (``grp_id * 2^52 + idx``), a missing value is 1.0, the group
    id is the slot. A token whose key or value does not parse is
    dropped whole."""
    labels, keys, vals, slots = [], [], [], []
    for line in lines:
        groups = [g for g in line.strip().split(";") if g]
        if not groups:
            continue
        try:
            label = float(groups[0])
        except ValueError:
            continue
        labels.append(1.0 if label > 0 else -1.0)
        k, v, s = [], [], []
        for grp in groups[1:]:
            toks = grp.split()
            if not toks:
                continue
            try:
                gid = int(toks[0])
            except ValueError:
                continue
            for tok in toks[1:]:
                i, _, x = tok.partition(":")
                try:
                    key = _wrap_i64(gid * SLOT_SPACE + int(i))
                    val = float(x) if x else 1.0
                except ValueError:
                    continue
                k.append(key)
                v.append(val)
                s.append(_wrap_i32(gid))
        keys.append(np.asarray(k, dtype=np.int64))
        vals.append(np.asarray(v, dtype=np.float32))
        slots.append(np.asarray(s, dtype=np.int32))
    return _batch_from_rows(labels, keys, vals, slots)


def parse_ps_sparse_binary(lines: List[str]) -> SparseBatch:
    """SPARSE_BINARY: "label;grp_id key key ...;" -- every token after
    the group id is a bare uint64 key, values implicitly 1; keys are
    striped by group (``grp_id * 2^52 + key``), the group id is the slot."""
    labels, keys, slots = [], [], []
    for line in lines:
        groups = [g for g in line.strip().split(";") if g]
        if not groups:
            continue
        try:
            label = float(groups[0])
        except ValueError:
            continue
        labels.append(1.0 if label > 0 else -1.0)
        k, s = [], []
        for grp in groups[1:]:
            toks = grp.split()
            if not toks:
                continue
            try:
                gid = int(toks[0])
            except ValueError:
                continue
            for tok in toks[1:]:
                try:
                    k.append(_wrap_i64(gid * SLOT_SPACE + int(tok)))
                    s.append(_wrap_i32(gid))
                except ValueError:
                    continue
        keys.append(np.asarray(k, dtype=np.int64))
        slots.append(np.asarray(s, dtype=np.int32))
    return _batch_from_rows(labels, keys, None, slots)


def parse_ps_dense(lines: List[str]) -> SparseBatch:
    """DENSE: "label;grp_id val val ...;" -- each value's key is its
    position in its group, striped by group (``grp_id * 2^52 + pos``,
    positions counted over the group's tokens, bad ones included)."""
    labels, keys, vals, slots = [], [], [], []
    for line in lines:
        groups = [g for g in line.strip().split(";") if g]
        if not groups:
            continue
        try:
            label = float(groups[0])
        except ValueError:
            continue
        labels.append(1.0 if label > 0 else -1.0)
        k, v, s = [], [], []
        for grp in groups[1:]:
            toks = grp.split()
            if not toks:
                continue
            try:
                gid = int(toks[0])
            except ValueError:
                continue
            for pos, tok in enumerate(toks[1:]):
                try:
                    x = float(tok)
                except ValueError:
                    continue
                k.append(_wrap_i64(gid * SLOT_SPACE + pos))
                v.append(x)
                s.append(_wrap_i32(gid))
        keys.append(np.asarray(k, dtype=np.int64))
        vals.append(np.asarray(v, dtype=np.float32))
        slots.append(np.asarray(s, dtype=np.int32))
    return _batch_from_rows(labels, keys, vals, slots)


def _parse_native(text: bytes, fn_name: str, max_rows: int) -> SparseBatch:
    """Parse ``text`` (whole lines) with the native library's ``fn_name``
    into a batch of at most ``max_rows`` rows. The library returns
    ``-(rows + 1)`` when its value buffer filled mid-stream: the parse is
    retried with twice the buffer."""
    fn = getattr(native.library(), fn_name)
    max_nnz = max(1024, len(text) // 2)
    while True:
        y = np.zeros(max_rows, np.float32)
        indptr = np.zeros(max_rows + 1, np.int64)
        indices = np.zeros(max_nnz, np.uint64)
        values = np.zeros(max_nnz, np.float32)
        slots = np.zeros(max_nnz, np.int32)
        out_nnz = ctypes.c_int64(0)
        rows = fn(
            text, len(text),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_rows, max_nnz, ctypes.byref(out_nnz),
        )
        if rows < 0:
            max_nnz *= 2
            continue
        nnz = out_nnz.value
        return SparseBatch(
            y=y[:rows].copy(),
            indptr=indptr[: rows + 1].copy(),
            # the raw 64 bits: criteo's murmur keys reach 2^63 and above
            indices=indices[:nnz].view(np.int64).copy(),
            # criteo is binary (keys only); the library still writes 1.0s
            values=None if fn_name == "ps_parse_criteo" else values[:nnz].copy(),
            slot_ids=slots[:nnz].copy(),
        )


_PARSERS = {
    "libsvm": parse_libsvm,
    "criteo": parse_criteo,
    "adfea": parse_adfea,
    "terafea": parse_terafea,
    "ps": parse_ps_sparse,
    "ps_sparse": parse_ps_sparse,
    "ps_sparse_binary": parse_ps_sparse_binary,
    "ps_dense": parse_ps_dense,
}
_NATIVE = {"libsvm": "ps_parse_libsvm", "criteo": "ps_parse_criteo"}


class ExampleParser:
    """Format-dispatching parser. libsvm and criteo take the native
    library unless ``use_native=False``; a library that does not build
    raises."""

    def __init__(self, format_: str = "libsvm", use_native: bool = True):
        f = format_.lower()
        if f not in _PARSERS:
            raise ValueError(f"unknown text format: {format_}")
        self.format = f
        self.use_native = use_native and f in _NATIVE

    def parse_lines(self, lines: List[str]) -> SparseBatch:
        if self.use_native and lines:
            blob = ("\n".join(lines) + "\n").encode()
            return _parse_native(blob, _NATIVE[self.format], len(lines) + 1)
        return _PARSERS[self.format](lines)

    def parse_text(self, text: bytes) -> SparseBatch:
        """Parse a raw byte chunk that ends at a line boundary, with no
        split into lines (the streaming path)."""
        if self.use_native and text:
            return _parse_native(text, _NATIVE[self.format], text.count(b"\n") + 1)
        return _PARSERS[self.format](text.decode().splitlines())
