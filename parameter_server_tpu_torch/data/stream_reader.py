"""Streaming minibatch reader over text files.

Counterpart of the line path of ``parameter_server_tpu/data/stream_reader.py``
(the reference's ``StreamReader``): ``minibatches(n)`` yields
``SparseBatch`` chunks of ``n`` examples across a list of (possibly
gzipped) files, parsed by ``ExampleParser``. The record formats and the
chunked native byte path (with ``rebatch``, which serves only those) are
not ported.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ..utils import file as psfile
from ..utils.sparse import SparseBatch
from .text_parser import ExampleParser


def _concat_batches(parts: List[SparseBatch]) -> SparseBatch:
    if len(parts) == 1:
        return parts[0]
    indptr = [np.zeros(1, np.int64)]
    offset = 0
    for p in parts:
        indptr.append(p.indptr[1:] + offset)
        offset += p.indptr[-1]
    binary = all(p.binary for p in parts)
    has_slots = all(p.slot_ids is not None for p in parts)
    return SparseBatch(
        y=np.concatenate([p.y for p in parts]),
        indptr=np.concatenate(indptr),
        indices=np.concatenate([p.indices for p in parts]),
        values=None if binary else np.concatenate([p.value_array() for p in parts]),
        slot_ids=np.concatenate([p.slot_ids for p in parts]) if has_slots else None,
    )


class StreamReader:
    def __init__(self, files: List[str], data_format: str = "libsvm"):
        if data_format in ("record", "ref_record", "bin"):
            raise NotImplementedError(
                f"data format {data_format!r} is not ported to the PyTorch package yet"
            )
        self.files = psfile.expand_globs(files)
        self.format = data_format
        self.parser = ExampleParser(data_format)

    def _lines(self) -> Iterator[str]:
        for path in self.files:
            yield from psfile.read_lines(path)

    def minibatches(self, size: int) -> Iterator[SparseBatch]:
        """Yield batches of ``size`` examples (the last may be smaller)."""
        lines: List[str] = []
        for line in self._lines():
            lines.append(line)
            if len(lines) >= size:
                yield self.parser.parse_lines(lines)
                lines = []
        if lines:
            yield self.parser.parse_lines(lines)

    def read_all(self) -> Optional[SparseBatch]:
        """The whole dataset as one batch, or None when it is empty."""
        parts = list(self.minibatches(1 << 16))
        if not parts:
            return None
        return _concat_batches(parts)
