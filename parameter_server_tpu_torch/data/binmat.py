"""Binary matrix files and the reference's MATLAB data helpers.

Counterpart of ``parameter_server_tpu/data/binmat.py``: the reference's
binary matrix container (``Matrix::writeToBinFile``), a ``<name>.info``
protobuf-text ``MatrixInfo`` beside raw little-endian arrays
``<name>.offset`` (uint64 CSR row offsets), ``<name>.index`` (uint32
column indices, uint64 where they do not fit), ``<name>.value``
(float64) and optionally ``<name>.key`` (uint64 global keys), and the
toolbox functions under their MATLAB names: ``load_bin``, ``save_bin``,
``bin2mat``, ``mat2bin``, ``saveas_pserver`` (the ps text format, which
``parse_ps_sparse`` / ``parse_ps_sparse_binary`` read back) and
``filter_fea`` (drop features seen at most ``pv`` times).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple, Union

import numpy as np

from ..utils.localizer import remap
from ..utils.sparse import SparseBatch


def save_bin(name: str, arr: np.ndarray, dtype=None) -> None:
    """Write a vector as raw little-endian binary (ref save_bin.m)."""
    a = np.asarray(arr)
    if dtype is not None:
        a = a.astype(dtype)
    a.ravel().tofile(name)


def load_bin(
    name: str, dtype="float64", offset: int = 0, count: int = -1
) -> np.ndarray:
    """Read a raw binary vector (ref load_bin.m: format/offset/length)."""
    dt = np.dtype(dtype)
    with open(name, "rb") as f:
        f.seek(dt.itemsize * offset)
        return np.fromfile(f, dtype=dt, count=count)


def _write_info(name: str, fields: list) -> None:
    lines = []
    for key, val in fields:
        if isinstance(val, tuple):  # range message {begin end}
            lines.append(f"{key} {{ begin: {val[0]} end: {val[1]} }}")
        elif isinstance(val, bool):
            lines.append(f"{key}: {'true' if val else 'false'}")
        else:
            lines.append(f"{key}: {val}")
    with open(name + ".info", "w") as f:
        f.write("\n".join(lines) + "\n")


def _read_info(name: str) -> dict:
    """Parse the MatrixInfo proto-text descriptor. Deliberately minimal
    (flat fields + one-level ``{ begin end }`` ranges) and enum-preserving
    — the config parser's enum coercion would rewrite DENSE/SPARSE."""
    out: dict = {}
    with open(name + ".info") as f:
        text = f.read()
    for key, body in re.findall(r"(\w+)\s*\{([^}]*)\}", text):
        rng = {}
        for k2, v2 in re.findall(r"(\w+)\s*:\s*(\S+)", body):
            rng[k2] = int(v2)
        out[key] = rng
    flat = re.sub(r"\w+\s*\{[^}]*\}", "", text)
    for key, val in re.findall(r"(\w+)\s*:\s*(\S+)", flat):
        if val in ("true", "false"):
            out[key] = val == "true"
        else:
            try:
                out[key] = int(val)
            except ValueError:
                out[key] = val
    return out


def mat2bin(
    name: str,
    mat: Union[np.ndarray, SparseBatch],
    keys: Optional[np.ndarray] = None,
) -> None:
    """Write the reference's binary matrix container (writeToBinFile
    layout, readable by bin2mat.m / :func:`bin2mat`)."""
    if isinstance(mat, np.ndarray):
        assert mat.ndim == 2
        _write_info(
            name,
            [
                ("type", "DENSE"),
                ("row_major", True),
                ("row", (0, mat.shape[0])),
                ("col", (0, mat.shape[1])),
                ("nnz", mat.size),
                ("sizeof_value", 8),
            ],
        )
        save_bin(name + ".value", mat, np.float64)
        return
    b: SparseBatch = mat
    # a non-localized batch can carry global 64-bit hash keys (criteo);
    # casting those to uint32 would silently corrupt the .index file, so
    # widen sizeof_index to 8 when the indices don't fit
    fits32 = b.nnz == 0 or (
        int(b.indices.min()) >= 0 and int(b.indices.max()) < 2**32
    )
    _write_info(
        name,
        [
            ("type", "SPARSE_BINARY" if b.binary else "SPARSE"),
            ("row_major", True),
            ("row", (0, b.n)),
            ("col", (0, b.cols)),
            ("nnz", b.nnz),
            ("sizeof_index", 4 if fits32 else 8),
            ("sizeof_value", 8),
        ],
    )
    save_bin(name + ".offset", b.indptr, np.uint64)
    if fits32:
        save_bin(name + ".index", b.indices, np.uint32)
    else:
        # .view keeps the raw 64 bits for keys >= 2^63 stored as negative int64
        save_bin(name + ".index", b.indices.astype(np.int64).view(np.uint64), np.uint64)
    if not b.binary:
        save_bin(name + ".value", b.values, np.float64)
    if keys is not None:
        save_bin(name + ".key", keys, np.uint64)


def bin2mat(
    name: str,
) -> Union[np.ndarray, Tuple[SparseBatch, Optional[np.ndarray]]]:
    """Load a binary matrix container (ref bin2mat.m). DENSE → float64
    ndarray; SPARSE/SPARSE_BINARY → (SparseBatch-without-labels, keys)."""
    info = _read_info(name)
    mtype = str(info.get("type", "SPARSE"))
    rows = int(info["row"]["end"]) - int(info["row"].get("begin", 0))
    cols = int(info["col"]["end"]) - int(info["col"].get("begin", 0))
    if "DENSE" in mtype:
        vals = load_bin(name + ".value", np.float64)
        return vals.reshape(rows, cols)
    indptr = load_bin(name + ".offset", np.uint64).astype(np.int64)
    if int(info.get("sizeof_index", 4)) == 8:
        indices = load_bin(name + ".index", np.uint64).view(np.int64)
    else:
        indices = load_bin(name + ".index", np.uint32).astype(np.int64)
    values = (
        None
        if "BINARY" in mtype
        else load_bin(name + ".value", np.float64).astype(np.float32)
    )
    keys = (
        load_bin(name + ".key", np.uint64)
        if os.path.exists(name + ".key")
        else None
    )
    batch = SparseBatch(
        y=np.zeros(rows, np.float32),
        indptr=indptr,
        indices=indices,
        values=values,
        num_cols=cols,
    )
    return batch, keys


def saveas_pserver(
    file_name: str,
    y: np.ndarray,
    batch: SparseBatch,
    group_id: Optional[np.ndarray] = None,
    binary: Optional[bool] = None,
) -> None:
    """Write examples in the ps text format (ref saveas_pserver.m):
    ``label;grp idx[:val] ...;grp ...;`` — parse_ps_sparse /
    parse_ps_sparse_binary read it back."""
    binary = batch.binary if binary is None else binary
    group_id = (
        np.zeros(batch.cols, np.int64)
        if group_id is None
        else np.asarray(group_id)
    )
    if not np.all(np.diff(group_id) >= 0):
        raise ValueError("group_id must be sorted (ref assert(issorted))")
    with open(file_name, "w") as f:
        for i in range(batch.n):
            f.write(f"{int(y[i])}")
            lo, hi = batch.indptr[i], batch.indptr[i + 1]
            pre_gid = None
            for e in range(lo, hi):
                col = int(batch.indices[e])
                gid = int(group_id[col])
                if gid != pre_gid:
                    f.write(f"; {gid}")
                    pre_gid = gid
                if binary:
                    f.write(f" {col}")
                else:
                    f.write(f" {col}:{batch.values[e]:g}")
            f.write(";\n")


def filter_fea(batch: SparseBatch, pv: int) -> Tuple[SparseBatch, np.ndarray]:
    """Drop features appearing <= pv times (ref filter_fea.m's
    ``sum(X) > pv`` pruning). Returns (filtered batch remapped to the kept
    columns, kept original column ids)."""
    keys, counts = np.unique(batch.indices, return_counts=True)
    keep = keys[counts > pv]
    return remap(batch, keep), keep
