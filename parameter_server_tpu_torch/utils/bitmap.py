"""Dense bitmap on the host (set, clear, test, fill, nnz).

Counterpart of ``parameter_server_tpu/utils/bitmap.py`` (the reference's
``bitmap.h``): host bookkeeping, such as darlin's active set. On the
device an active set is a mask tensor.
"""

from __future__ import annotations

import numpy as np


class Bitmap:
    def __init__(self, size: int = 0, value: bool = False):
        self._bits = np.full(size, bool(value), dtype=bool)

    def resize(self, size: int, value: bool = False) -> None:
        self._bits = np.full(size, bool(value), dtype=bool)

    def set(self, i: int) -> None:
        self._bits[i] = True

    def clear(self, i: int) -> None:
        self._bits[i] = False

    def test(self, i: int) -> bool:
        return bool(self._bits[i])

    def fill(self, value: bool) -> None:
        self._bits.fill(bool(value))

    def nnz(self) -> int:
        return int(self._bits.sum())

    @property
    def size(self) -> int:
        return len(self._bits)

    def array(self) -> np.ndarray:
        return self._bits
