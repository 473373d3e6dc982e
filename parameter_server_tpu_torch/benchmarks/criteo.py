"""The reference's Criteo configuration, with generated data.

``configs/criteo/online_l1lr.conf`` mirrors the reference's
``example/linear/ctr/online_l1lr.conf`` on the Criteo display-ads text
format: 10000-row minibatches, bounded delay 4, a count-min tail filter
(keys seen fewer than 4 times are dropped), L1 FTRL, a 2^22-slot table.
Its data comes from a download script; here it is generated from a seed.

Each line is a label, 13 integer fields and 26 categorical fields as
8-hex-digit 32-bit ids, tab-separated. Categorical field f draws a rank
in ``[0, CARDINALITIES[f])`` with ``benchmarks/ctr.py``'s log-uniform
(Zipf-like, exponent 1) law, so the tail filter keeps each field's head,
and scatters it over 32 bits by an odd multiplier and a field offset.
Integer fields are log-uniform counts below 4096, a fifth of them
empty. Labels: every 16th id pushes towards a click and every 16th
towards none (by a hash of the id), a row's label is the sign of its
sum, ties broken by a seeded coin. The text is assembled as one byte
matrix, not line by line.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .ctr import ctr_conf

CONF = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs", "criteo", "online_l1lr.conf"
)
# distinct values of each categorical field of the Criteo Kaggle
# display-advertising data, as DLRM's reference data loader counts them
CARDINALITIES = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683, 8351593,
                 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
                 142572)
INT_FIELDS, INT_DIGITS, INT_BITS, INT_EMPTY = 13, 4, 12, 0.2
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def criteo_rows(rng: np.random.Generator, n: int):
    """``(labels in {0, 1} [n], ints [n, 13] int64 with -1 for empty,
    ids [n, 26] uint32)``."""
    card = np.asarray(CARDINALITIES, np.float64)
    rank = np.floor(np.exp2(rng.random((n, len(card))) * np.log2(card))).astype(np.int64) - 1
    field = np.arange(len(card), dtype=np.int64)
    ids = ((rank * 0x9E3779B1 + field * 0x632BE5AB) & 0xFFFFFFFF).astype(np.uint32)
    ints = np.floor(np.exp2(rng.random((n, INT_FIELDS)) * INT_BITS)).astype(np.int64) - 1
    ints[rng.random((n, INT_FIELDS)) < INT_EMPTY] = -1
    h = (((ids.astype(np.int64) + 0x7F4A7C15) * 2654435761) & 0xFFFFFFFF) >> 7
    margin = ((h % 16 == 0).astype(np.int64) - (h % 16 == 1)).sum(1)
    coin = (rng.random(n) < 0.5).astype(np.int64)
    labels = np.where(margin > 0, 1, np.where(margin < 0, 0, coin))
    return labels, ints, ids


def criteo_text(labels: np.ndarray, ints: np.ndarray, ids: np.ndarray) -> bytes:
    """The lines of the rows as bytes: a character matrix, one row a
    line, and a mask of the characters each line keeps."""
    n = len(labels)
    cols, keep = [(ord("0") + labels).astype(np.uint8)[:, None]], [np.ones((n, 1), bool)]
    tab = np.full((n, 1), ord("\t"), np.uint8)
    ones = np.ones((n, 1), bool)
    place = 10 ** np.arange(INT_DIGITS - 1, -1, -1, dtype=np.int64)  # 1000 .. 1
    for f in range(ints.shape[1]):
        v = ints[:, f:f + 1]
        digits = np.where(v < 0, 0, 1 + (v >= 10) + (v >= 100) + (v >= 1000))
        # the digit at column j: v's digit at 10^(digits-1-j), left aligned
        shift = np.arange(INT_DIGITS) + (INT_DIGITS - digits)
        dig = (np.maximum(v, 0) // place[np.minimum(shift, INT_DIGITS - 1)]) % 10
        cols += [tab, (ord("0") + dig).astype(np.uint8)]
        keep += [ones, np.arange(INT_DIGITS) < digits]
    nib = np.arange(28, -1, -4, dtype=np.uint32)
    for f in range(ids.shape[1]):
        cols += [tab, _HEX[(ids[:, f:f + 1] >> nib) & 0xF]]
        keep += [ones, np.ones((n, 8), bool)]
    cols.append(np.full((n, 1), ord("\n"), np.uint8))
    keep.append(ones)
    return np.concatenate(cols, 1)[np.concatenate(keep, 1)].tobytes()


def write_criteo_shards(directory: str, shards: int, rows: int, seed: int) -> List[str]:
    """Write ``shards`` Criteo text files ``part-001``... of ``rows``
    lines each. Returns the paths."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(shards):
        path = os.path.join(directory, f"part-{s + 1:03d}")
        with open(path, "wb") as f:
            f.write(criteo_text(*criteo_rows(rng, rows)))
        paths.append(path)
    return paths


def criteo_conf(data_glob: str, model_out: str, **sgd) -> str:
    """The Criteo conf with its training files and model output pointed
    elsewhere; each ``sgd`` item sets (or adds) an ``async_sgd`` field."""
    with open(CONF) as f:
        return ctr_conf(data_glob, model_out, conf_text=f.read(), **sgd)
