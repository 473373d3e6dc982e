"""KVStore: one factory over the key-value containers.

Counterpart of ``parameter_server_tpu/parameter/kv_store.py`` (the
reference's ``src/parameter/kv_store.h`` is a placeholder):
``kv_store(kind=...)`` returns the container of that kind, and the
concrete classes are re-exported.
"""

from __future__ import annotations

from .kv_layer import KVLayer
from .kv_map import AddEntry, AssignEntry, KVMap
from .kv_vector import KVVector

__all__ = ["KVVector", "KVMap", "KVLayer", "AssignEntry", "AddEntry", "kv_store"]


def kv_store(kind: str = "vector", **kwargs):
    """A ``KVVector`` (``"vector"``), ``KVMap`` (``"map"``) or
    ``KVLayer`` (``"layer"``) built from ``kwargs``."""
    if kind == "vector":
        return KVVector(**kwargs)
    if kind == "map":
        return KVMap(**kwargs)
    if kind == "layer":
        return KVLayer(**kwargs)
    raise ValueError(f"unknown kv store kind: {kind}")
