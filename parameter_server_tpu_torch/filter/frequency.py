"""Tail-feature frequency filter: a count-min sketch of key counts.

Counterpart of ``parameter_server_tpu/filter/frequency.py``:
``insert_keys(keys, counts)`` accumulates, ``query_keys(keys, freq)``
returns the keys whose estimated count is at least ``freq``.
"""

from __future__ import annotations

import numpy as np

from ..utils.sketch import CountMin


class FrequencyFilter:
    def __init__(self, n: int = 1 << 20, k: int = 2):
        self._sketch = CountMin(n, k)

    def insert_keys(self, keys: np.ndarray, counts=1) -> None:
        self._sketch.insert(keys, counts)

    def query_keys(self, keys: np.ndarray, freq: int) -> np.ndarray:
        """Keys whose estimated frequency is >= ``freq`` (order kept)."""
        if freq <= 0:
            return np.asarray(keys)
        return np.asarray(keys)[self._sketch.query(keys) >= freq]
