"""Print the first parsed examples of a file.

Counterpart of ``parameter_server_tpu/data/show_example.py`` (the
reference's ``show_example``): reads this repo's batch records
(``text2record``'s output) or text in any format ``ExampleParser``
knows, and prints each example as a protobuf-debug-style line, slot by
slot::

    python -m parameter_server_tpu_torch.data.show_example -input part-0 \\
        -format criteo -n 3
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterator, List

import numpy as np

from ..utils import file as psfile
from ..utils.recordio import RecordReader
from ..utils.sparse import SparseBatch
from .example import batch_from_bytes
from .text_parser import _PARSERS, ExampleParser

_FORMATS = sorted(_PARSERS) + ["recordio"]


def format_example(batch: SparseBatch, i: int) -> str:
    """Example ``i`` as ``Example::ShortDebugString()`` shows it: the
    label slot (id 0), then each feature slot with its keys (unsigned)
    and, unless the batch is binary, its values."""
    lo, hi = int(batch.indptr[i]), int(batch.indptr[i + 1])
    keys = batch.indices[lo:hi]
    vals = None if batch.values is None else batch.values[lo:hi]
    slots = (batch.slot_ids[lo:hi] if batch.slot_ids is not None
             else np.ones(hi - lo, dtype=np.int32))
    parts: List[str] = ["slot { id: 0 val: %g }" % float(batch.y[i])]
    for sid in np.unique(slots):
        sel = np.flatnonzero(slots == sid)
        fields = [f"id: {int(sid)}"]
        fields += [f"key: {int(k) & 0xFFFFFFFFFFFFFFFF}" for k in keys[sel]]
        if vals is not None:
            fields += ["val: %g" % float(v) for v in vals[sel]]
        parts.append("slot { %s }" % " ".join(fields))
    return " ".join(parts)


def _batches(path: str, fmt: str, limit: int) -> Iterator[SparseBatch]:
    if fmt == "recordio":
        with psfile.open_read(path, "rb") as f:
            for payload in RecordReader(f):
                yield batch_from_bytes(payload)
        return
    lines: List[str] = []
    with psfile.open_read(path, "rt") as f:
        for line in f:
            if line.strip():
                lines.append(line)
            if len(lines) >= limit:
                break
    if lines:
        yield ExampleParser(fmt).parse_lines(lines)


def show_example(path: str, fmt: str, n: int, out=None) -> int:
    """Print the first ``n`` examples; returns how many were printed."""
    out = out if out is not None else sys.stdout
    shown = 0
    for batch in _batches(path, fmt, n):
        for i in range(batch.n):
            if shown >= n:
                return shown
            print(format_example(batch, i), file=out)
            shown += 1
    return shown


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="show_example",
                                 description="print the first n parsed examples")
    # the reference's single-dash flags (-input/-format/-n) are accepted
    ap.add_argument("-input", "--input", required=True, help="input file")
    ap.add_argument("-format", "--format", default="recordio", choices=_FORMATS,
                    help="input format (default: recordio)")
    ap.add_argument("-n", "--n", type=int, default=3,
                    help="show the first n instances in text format")
    args = ap.parse_args(argv)
    if args.n <= 0:
        ap.error("-n must be positive")
    try:
        shown = show_example(args.input, args.format, args.n)
    except FileNotFoundError as e:
        ap.error(str(e))
    except BrokenPipeError:  # e.g. `... | head`
        return 0
    if shown == 0:
        print("(no examples)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
