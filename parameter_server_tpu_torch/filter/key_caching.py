"""Key caching (the reference's ``src/filter/key_caching.h``).

Copy of ``parameter_server_tpu/filter/key_caching.py``. Repeated pushes
and pulls over the same key set need not resend the keys: the sender
attaches a CRC32C signature of the key array
(:func:`~..utils.crc32c.array_signature`); where the receiver's cache
for (channel, key range) holds the same signature, the keys are left
off the wire and restored from the cache. A miss raises ``KeyError``.
The cache lives in the filter instance, one a peer's chain.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..system.message import FilterSpec, Message
from ..utils import crc32c
from .base import Filter, register


@register
class KeyCachingFilter(Filter):
    TYPE = "key_caching"
    MAX_SIG_LEN = 2048

    def __init__(self) -> None:
        # (channel, key_range) -> (signature, cached keys)
        self._cache: Dict[Tuple[int, Tuple[int, int]], Tuple[int, object]] = {}

    def _cache_key(self, msg: Message):
        kr = msg.task.key_range
        return (msg.task.key_channel, (kr.begin, kr.end))

    def encode(self, msg: Message, spec: FilterSpec) -> Message:
        if msg.key is None:
            spec.extra.pop("signature", None)
            return msg
        sig = crc32c.array_signature(msg.key, self.MAX_SIG_LEN)
        spec.extra["signature"] = sig
        ck = self._cache_key(msg)
        cached = self._cache.get(ck)
        if cached is not None and cached[0] == sig and len(cached[1]) == len(msg.key):
            msg.key = None  # a hit: the keys stay off the wire
        else:
            self._cache[ck] = (sig, msg.key)
        if spec.clear_cache_if_done and not msg.task.more:
            self._cache.pop(ck, None)
        return msg

    def decode(self, msg: Message, spec: FilterSpec) -> Message:
        sig = spec.extra.get("signature")
        if sig is None:
            return msg
        ck = self._cache_key(msg)
        if msg.key is not None:
            self._cache[ck] = (sig, msg.key)
            return msg
        cached = self._cache.get(ck)
        if cached is None or cached[0] != sig:
            raise KeyError(f"key cache miss for {ck} (signature {sig})")
        msg.key = cached[1]
        if spec.clear_cache_if_done and not msg.task.more:
            self._cache.pop(ck, None)
        return msg
