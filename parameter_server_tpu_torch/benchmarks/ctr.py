"""The reference's CTR configuration, with generated data.

``configs/ctr/online_l1lr.conf`` mirrors the reference's production
``example/linear/ctr/online_l1lr.conf``: SPARSE_BINARY text shards,
10000-row minibatches, KEY_CACHING plus a 1-byte FIXING_FLOAT push
filter, bounded delay 4, a count-min tail filter (keys seen fewer than
4 times are dropped), elastic-net FTRL, 10 passes over the data. Its
data comes from a download script; here it is generated from a seed.

Rows hold 32 keys (the configs/synth_data.py shape) drawn from 2^24
with a log-uniform (Zipf-like, exponent 1) rank law, so the tail filter
keeps the head of the key space as on real click logs, and each rank is
scattered over the key space by an odd multiplier (a bijection mod
2^24). Labels: every 16th key pushes towards a click and every 16th
towards none (by a hash of the key); a row's label is the sign of its
sum, ties broken by a seeded coin.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

CONF = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs", "ctr", "online_l1lr.conf"
)
KEY_BITS, NNZ = 24, 32


def ctr_rows(rng: np.random.Generator, n: int, key_bits: int = KEY_BITS, nnz: int = NNZ):
    """``(labels in {0, 1} [n], keys [n, nnz] int64, first [n, nnz] bool)``:
    keys sorted within each row, ``first`` marking the first copy of a
    key in its row (a row's features are its distinct keys)."""
    mask = (1 << key_bits) - 1
    rank = np.floor(np.exp2(rng.random((n, nnz)) * key_bits)).astype(np.int64) - 1
    keys = np.sort((rank * 0x9E3779B1) & mask, axis=1)
    first = np.ones_like(keys, dtype=bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    h = (((keys + 0x7F4A7C15) * 2654435761) & 0xFFFFFFFF) >> 7
    w = (h % 16 == 0).astype(np.int64) - (h % 16 == 1)
    margin = (w * first).sum(1)
    coin = (rng.random(n) < 0.5).astype(np.int64)
    labels = np.where(margin > 0, 1, np.where(margin < 0, 0, coin))
    return labels, keys, first


def write_ctr_shards(directory: str, shards: int, rows: int, seed: int,
                     key_bits: int = KEY_BITS) -> List[str]:
    """Write ``shards`` SPARSE_BINARY files ``part-001``... of ``rows``
    lines each ("label; 0 key key ...;", distinct keys in ascending
    order, as configs/synth_data.py writes them). Returns the paths."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(shards):
        labels, keys, first = ctr_rows(rng, rows, key_bits)
        path = os.path.join(directory, f"part-{s + 1:03d}")
        with open(path, "w") as f:
            for label, row, keep in zip(labels.tolist(), keys.tolist(), first.tolist()):
                feats = " ".join(str(k) for k, f_ in zip(row, keep) if f_)
                f.write(f"{label}; 0 {feats};\n")
        paths.append(path)
    return paths


def ctr_minibatches(directory: str, rows: int, seed: int):
    """``(minibatches, config)``: one shard of ``rows`` generated rows
    written under ``directory`` and read as the CLI reads the CTR conf
    (its minibatch size, its count-min tail filter)."""
    from ..apps.linear.config import parse_conf
    from ..learner.sgd import MinibatchReader

    write_ctr_shards(directory, 1, rows, seed)
    c = parse_conf(ctr_conf(os.path.join(directory, "part.*"), os.path.join(directory, "model")))
    s = c.async_sgd
    reader = MinibatchReader(files=c.training_data.file, minibatch_size=s.minibatch,
                             data_format=c.training_data.text)
    reader.init_filter(s.countmin_n, s.countmin_k, s.tail_feature_freq)
    with reader:
        return list(reader), c


def ctr_conf(data_glob: str, model_out: str, conf_text: str = None, **sgd) -> str:
    """The CTR conf with its training files and model output pointed
    elsewhere; each ``sgd`` item sets (or adds) an ``async_sgd`` field.
    Everything else is the conf's own."""
    text = conf_text if conf_text is not None else open(CONF).read()
    text = re.sub(r'(training_data \{[^}]*file: )"[^"]*"', rf'\1"{data_glob}"', text)
    text = re.sub(r'(model_output \{[^}]*file: )"[^"]*"', rf'\1"{model_out}"', text)
    for key, value in sgd.items():
        line = f"  {key}: {value}\n"
        text, n = re.subn(rf"(?m)^  {key}: .*\n", line, text)
        if not n:
            text = text.replace("async_sgd {\n", "async_sgd {\n" + line, 1)
    return text
