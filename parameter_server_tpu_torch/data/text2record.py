"""Convert text data to record files.

Counterpart of ``parameter_server_tpu/data/text2record.py`` (the
reference's ``text2proto``): parse text in any format ``ExampleParser``
knows and write this repo's CRC-framed batch records (``format:
RECORD``, read back with ``StreamReader`` format ``record``), or with
``--ref-format`` the reference's protobuf ``Example`` records (``format:
PROTO``, format ``ref_record``), which a reference process reads too::

    python -m parameter_server_tpu_torch.data.text2record \\
        --input data/part-* --format criteo --output data/part.rec \\
        [--batch 65536] [--ref-format]
"""

from __future__ import annotations

import argparse
import sys

from ..utils import file as psfile
from ..utils.recordio import RecordWriter
from .example import batch_to_bytes
from .ref_interop import batch_to_ref_payloads, write_ref_records
from .stream_reader import StreamReader


def convert(inputs, data_format: str, output: str, batch_size: int = 65536) -> int:
    """Text -> batch records, one record a ``batch_size``-row batch;
    returns the example count."""
    reader = StreamReader(list(inputs), data_format)
    n = 0
    with open(output, "wb") as f:
        writer = RecordWriter(f)
        for batch in reader.minibatches(batch_size):
            writer.write_record(batch_to_bytes(batch))
            n += batch.n
    return n


def convert_ref(inputs, data_format: str, output: str, batch_size: int = 65536) -> int:
    """Text -> the reference's ``Example`` records, one a row; returns
    the example count."""
    reader = StreamReader(list(inputs), data_format)
    return write_ref_records(
        output,
        (payload for batch in reader.minibatches(batch_size)
         for payload in batch_to_ref_payloads(batch)),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", nargs="+", required=True)
    ap.add_argument("--format", default="libsvm")
    ap.add_argument("--output", required=True)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--ref-format", action="store_true",
                    help="write the reference's protobuf Example recordio format")
    args = ap.parse_args(argv)
    files = psfile.expand_globs(args.input)
    if not files:
        print(f"no input files match {args.input}", file=sys.stderr)
        return 2
    fn = convert_ref if args.ref_format else convert
    n = fn(files, args.format, args.output, args.batch)
    print(f"wrote {n} examples to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
