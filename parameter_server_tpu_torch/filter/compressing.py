"""Payload compression (the reference's ``src/filter/compressing.h``).

Copy of ``parameter_server_tpu/filter/compressing.py``. Each value array
goes through ``utils/codec.py`` (the native LZ block codec; an
incompressible payload rides raw) and travels as a uint8 frame; each
array's dtype and shape ride in the spec and restore it on decode.
"""

from __future__ import annotations

import numpy as np

from ..system.message import FilterSpec, Message
from ..utils import codec
from .base import Filter, register


@register
class CompressingFilter(Filter):
    TYPE = "compressing"

    def encode(self, msg: Message, spec: FilterSpec) -> Message:
        meta = []
        out = []
        for v in msg.values:
            raw = np.ascontiguousarray(v)
            blob = codec.compress(raw.tobytes())
            meta.append((str(raw.dtype), raw.shape))
            out.append(np.frombuffer(blob, dtype=np.uint8))
        spec.extra["meta"] = meta
        msg.values = out
        return msg

    def decode(self, msg: Message, spec: FilterSpec) -> Message:
        meta = spec.extra.get("meta")
        if meta is None:
            return msg
        out = []
        for v, (dtype, shape) in zip(msg.values, meta):
            dt = np.dtype(dtype)
            expected = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            raw = codec.decompress(v.tobytes(), expected_size=expected)
            out.append(np.frombuffer(raw, dtype=dt).reshape(shape).copy())
        msg.values = out
        return msg
