"""CRC32C (Castagnoli) checksums of the record files.

Counterpart of ``value``, ``masked`` and ``unmask`` in
``parameter_server_tpu/utils/crc32c.py`` (the reference's
``util/crc32c``): the polynomial 0x82F63B78 and the reference's masking,
so a record written by either package reads in the other. ``value``
runs the port's native library (``ps_crc32c`` in ``native/psnative.cc``,
slicing-by-8); a library that does not build raises. :func:`value_ref`
is the plain table loop the tests hold it to, not a fallback.
"""

from __future__ import annotations

import numpy as np

from .. import native

_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8


def value(data) -> int:
    """CRC32C of a byte string (or of an array's bytes)."""
    raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    return int(native.library().ps_crc32c(raw, len(raw)))


def value_ref(data) -> int:
    """The plain version of :func:`value`: one table lookup a byte."""
    raw = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    c = 0xFFFFFFFF
    for b in raw:
        c = (c >> 8) ^ _TABLE[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _make_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table.append(c)
    return table


_TABLE = _make_table()


def masked(crc: int) -> int:
    """The stored form of a CRC (rotate right 15, add a constant), so a
    CRC of data that holds CRCs does not degenerate."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(m: int) -> int:
    rot = (m - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF
