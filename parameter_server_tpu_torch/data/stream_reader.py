"""Streaming minibatch reader over text and record files.

Counterpart of ``parameter_server_tpu/data/stream_reader.py`` (the
reference's ``StreamReader``): ``minibatches(n)`` yields ``SparseBatch``
chunks of ``n`` examples across a list of (possibly gzipped) files.
Text is parsed by ``ExampleParser``; ``record`` files hold this repo's
CRC-framed batches (``data/example.py``, a conf's ``format: RECORD``)
and ``ref_record`` files the reference's protobuf ``Example`` records
(``data/ref_interop.py``, ``format: PROTO``). ``minibatches_bytes``
parses text in line-aligned byte chunks on threads; the record formats
and text formats without a native parser take ``minibatches`` there.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from ..utils import file as psfile
from ..utils import recordio
from ..utils.sparse import SparseBatch
from .example import batch_from_bytes
from .ref_interop import decode_example, example_slots_to_row, iter_ref_records, rows_to_batch
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


def rebatch(parts_iter: Iterator[SparseBatch], size: int) -> Iterator[SparseBatch]:
    """Re-slice a stream of batches of any size into ``size``-row
    minibatches (the last may be smaller)."""
    pending: List[SparseBatch] = []
    count = 0
    for b in parts_iter:
        pending.append(b)
        count += b.n
        if count < size:
            continue
        merged = _concat_batches(pending)
        lo = 0
        while merged.n - lo >= size:
            yield merged.slice_rows(lo, lo + size)
            lo += size
        rest = merged.slice_rows(lo, merged.n)
        pending = [rest] if rest.n else []
        count = rest.n
    if count:
        yield _concat_batches(pending)


class StreamReader:
    """``data_format``: a text format of ``ExampleParser``, ``record`` or
    ``ref_record``; any other name raises ``ValueError``."""

    def __init__(self, files: List[str], data_format: str = "libsvm"):
        self.files = psfile.expand_globs(files)
        self.format = data_format
        self.parser = (
            ExampleParser(data_format) if data_format not in ("record", "ref_record") else None
        )

    def _lines(self) -> Iterator[str]:
        for path in self.files:
            yield from psfile.read_lines(path)

    def _record_batches(self) -> Iterator[SparseBatch]:
        for path in self.files:
            with psfile.open_read(path, "rb") as f:
                for payload in recordio.RecordReader(f):
                    yield batch_from_bytes(payload)

    def _ref_record_batches(self, size: int) -> Iterator[SparseBatch]:
        """One decoded ``Example`` a record, ``size`` of them a batch."""
        rows: List = []
        for path in self.files:
            for payload in iter_ref_records(path):
                rows.append(example_slots_to_row(decode_example(payload)))
                if len(rows) >= size:
                    yield rows_to_batch(rows)
                    rows = []
        if rows:
            yield rows_to_batch(rows)

    def minibatches(self, size: int) -> Iterator[SparseBatch]:
        """Yield batches of ``size`` examples (the last may be smaller)."""
        if self.format == "record":
            yield from rebatch(self._record_batches(), size)
            return
        if self.format == "ref_record":
            yield from self._ref_record_batches(size)
            return
        lines: List[str] = []
        for line in self._lines():
            lines.append(line)
            if len(lines) >= size:
                yield self.parser.parse_lines(lines)
                lines = []
        if lines:
            yield self.parser.parse_lines(lines)

    def _byte_chunks(self, chunk_bytes: int) -> Iterator[bytes]:
        """Line-aligned raw byte chunks across all files."""
        for path in self.files:
            tail = b""
            with psfile.open_read(path, "rb") as f:
                while True:
                    buf = f.read(chunk_bytes)
                    if not buf:
                        break
                    buf = tail + buf
                    cut = buf.rfind(b"\n")
                    if cut < 0:
                        tail = buf
                        continue
                    tail = buf[cut + 1 :]
                    yield buf[: cut + 1]
            # a file without a final newline still ends its own last line:
            # the tail never joins the next file's first line
            if tail:
                yield tail + b"\n"

    def minibatches_bytes(self, size: int, chunk_bytes: int = 16 << 20,
                          threads: int = 4) -> Iterator[SparseBatch]:
        """The batches of :meth:`minibatches`, from line-aligned byte
        chunks parsed on ``threads`` threads (at most ``threads + 2``
        chunks in memory). The record formats, text formats without a
        native parser, and a parser built with ``use_native=False`` take
        :meth:`minibatches`."""
        if self.parser is None or not self.parser.use_native:
            yield from self.minibatches(size)
            return

        def parsed_chunks() -> Iterator[SparseBatch]:
            chunks = self._byte_chunks(chunk_bytes)
            futs: collections.deque = collections.deque()
            with ThreadPoolExecutor(threads) as pool:

                def fill() -> None:
                    while len(futs) < threads + 2:
                        c = next(chunks, None)
                        if c is None:
                            return
                        futs.append(pool.submit(self.parser.parse_text, c))

                fill()
                while futs:
                    b = futs.popleft().result()
                    fill()
                    yield b

        yield from rebatch(parsed_chunks(), size)

    def read_all(self) -> Optional[SparseBatch]:
        """The whole dataset as one batch, or None when it is empty."""
        parts = list(self.minibatches(1 << 16))
        if not parts:
            return None
        return _concat_batches(parts)
