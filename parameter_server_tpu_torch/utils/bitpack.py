"""Bit-packed wire format of slot-id and label streams.

Counterpart of ``parameter_server_tpu/utils/bitpack.py``. Integers bound
by the table size travel as a little-endian bitstream of ``bits =
ceil(log2 S)`` bits a value: value ``i`` holds stream bits ``[i*bits,
(i+1)*bits)``, stream bit ``k`` is bit ``k & 7`` of byte ``k >> 3``, and
the words are the same bytes read as ``<u4`` (bit ``k & 31`` of word
``k >> 5``); a value may straddle two words.

The host half packs with numpy, or with the native library
(``ps_pack_bits``, ``ps_hash_slots_packbits``) from 4096 values on, as
``utils/murmur.hash_slots`` hashes; both give the same bytes. The device
half unpacks with torch, holding uint32 words in int64 (torch has almost
no uint32 arithmetic), on whatever device the words lie.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import native
from .murmur import hash_slots

_M32 = 0xFFFFFFFF
_NATIVE_MIN = 4096  # values: below this numpy packs as fast


def slot_bits(num_slots: int, sentinel: bool = False) -> int:
    """Bits for ids in [0, num_slots), one value more when the padding
    sentinel (== num_slots) must be representable."""
    top = num_slots if sentinel else num_slots - 1
    return max(1, int(top).bit_length())


def packed_nbytes(n: int, bits: int) -> int:
    return (n * bits + 7) // 8


def packed_nwords(n: int, bits: int) -> int:
    """uint32 words holding n values of ``bits``, plus one slack word:
    the unpacker reads ``words[lo + 1]`` for every value."""
    return (n * bits + 31) // 32 + 1


def pack_bits_np(vals: np.ndarray, bits: int) -> np.ndarray:
    """The plain numpy pack (the reference for the native one)."""
    v = np.ascontiguousarray(vals, dtype=np.uint32).ravel()
    bitmat = ((v[:, None] >> np.arange(bits, dtype=np.uint32)) & np.uint32(1)).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1), bitorder="little")


def pack_bits(vals: np.ndarray, bits: int) -> np.ndarray:
    """int32 values -> little-endian uint8 bitstream."""
    v = np.ascontiguousarray(vals, dtype=np.int32).ravel()
    if v.size < _NATIVE_MIN:
        return pack_bits_np(v, bits)
    out = np.zeros(packed_nbytes(v.size, bits), np.uint8)
    native.library().ps_pack_bits(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), v.size, bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def hash_slots_packed(keys: np.ndarray, num_slots: int, bits: int, seed: int = 0,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Hash -> slot -> bitstream in one pass over raw keys, equal to
    ``pack_bits(hash_slots(keys))``. ``out``: a C-contiguous uint8
    buffer of exactly ``packed_nbytes(n, bits)``, written in place."""
    k = np.asarray(keys)
    k = k.view(np.uint64) if k.dtype == np.int64 and k.flags.c_contiguous \
        else np.ascontiguousarray(k, dtype=np.uint64)
    k = k.ravel()
    nbytes = packed_nbytes(k.size, bits)
    if out is not None and (out.dtype != np.uint8 or not out.flags.c_contiguous
                            or out.size != nbytes):
        raise ValueError(f"out must be a contiguous uint8 buffer of {nbytes} bytes")
    if k.size < _NATIVE_MIN:
        stream = pack_bits_np(hash_slots(k, num_slots, seed), bits)
        if out is None:
            return stream
        out[:] = stream
        return out
    if out is None:
        out = np.empty(nbytes, np.uint8)
    native.library().ps_hash_slots_packbits(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), k.size, seed, num_slots, bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def stream_to_words(stream: np.ndarray, n: int, bits: int) -> np.ndarray:
    """A byte stream padded to the word array the unpacker reads."""
    buf = np.zeros(packed_nwords(n, bits) * 4, np.uint8)
    buf[: stream.size] = stream
    return buf.view("<u4")


def words_i64(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (stored as uint32 or as their int32 view) -> int64
    values in [0, 2^32)."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    return words.to(torch.int64) & _M32


def unpack_bits(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Word array -> int32 [n], ``bits`` <= 31: two word gathers and
    shifts a value (the second word holds the high bits of a value that
    straddles the boundary)."""
    w = words_i64(words)
    pos = torch.arange(n, device=w.device, dtype=torch.int64) * bits
    lo = pos >> 5
    sh = pos & 31
    w0 = w.index_select(0, lo)
    w1 = w.index_select(0, lo + 1)
    v = (w0 >> sh) | torch.where(sh == 0, 0, (w1 << (32 - sh)) & _M32)
    return (v & ((1 << bits) - 1)).to(torch.int32)


def unpack_sign_bits(bits_u8: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 bit array -> float32 ±1 [n]."""
    r = torch.arange(n, device=bits_u8.device, dtype=torch.int64)
    byte = bits_u8.index_select(0, r >> 3).to(torch.int64)
    return ((byte >> (r & 7)) & 1).to(torch.float32) * 2.0 - 1.0
