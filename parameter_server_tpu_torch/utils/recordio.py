"""CRC-framed record files.

Counterpart of ``parameter_server_tpu/utils/recordio.py``: each record is
a header ``[masked crc32c(payload): uint32 LE][length: uint32 LE]`` and
then the payload (any bytes; ``data/example.py`` packs a batch into
one). Files written by either package read in the other.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Optional

from . import crc32c

_HEADER = struct.Struct("<II")  # masked crc, length


class RecordWriter:
    def __init__(self, f: BinaryIO):
        self._f = f

    def write_record(self, payload: bytes) -> None:
        self._f.write(_HEADER.pack(crc32c.masked(crc32c.value(payload)), len(payload)))
        self._f.write(payload)

    def close(self) -> None:
        self._f.close()


class RecordReader:
    def __init__(self, f: BinaryIO):
        self._f = f

    def read_record(self) -> Optional[bytes]:
        """The next payload, or None at the end of the file; raises
        ``IOError`` on a truncated record or a CRC mismatch."""
        hdr = self._f.read(_HEADER.size)
        if len(hdr) < _HEADER.size:
            return None
        crc, length = _HEADER.unpack(hdr)
        payload = self._f.read(length)
        if len(payload) < length:
            raise IOError("truncated record")
        if crc32c.unmask(crc) != crc32c.value(payload):
            raise IOError("record crc mismatch")
        return payload

    def __iter__(self) -> Iterator[bytes]:
        while (rec := self.read_record()) is not None:
            yield rec
