"""Filter framework: per-message encode/decode plugins.

Copy of ``parameter_server_tpu/filter/base.py`` (the reference's
``src/filter/filter.{h,cc}``). Importing this module registers the five
built-in filters (``key_caching``, ``fixing_float``, ``compressing``,
``sparse``, ``add_noise``); a spec naming any other type raises
``ValueError``. An empty chain (the aux runtime's metric reports)
passes a message through.

The reference applies an ordered filter chain to every message in
Van::Send (encode) and Van::Recv (decode, reverse order): compression,
quantization, key caching, noise. Here the chain transforms host-side
``Message`` objects on the control plane.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

from ..system.message import FilterSpec, Message


class Filter:
    """One filter; stateful per peer pair like ref RemoteNode's filter
    cache (remote_node.cc FindFilterOrCreate)."""

    TYPE = "base"

    def encode(self, msg: Message, spec: FilterSpec) -> Message:
        return msg

    def decode(self, msg: Message, spec: FilterSpec) -> Message:
        return msg


_REGISTRY: Dict[str, Type[Filter]] = {}


def register(cls: Type[Filter]) -> Type[Filter]:
    _REGISTRY[cls.TYPE] = cls
    return cls


def create(type_: str) -> Filter:
    """Factory (ref filter.cc Filter::create switch)."""
    if type_ not in _REGISTRY:
        raise ValueError(f"unknown filter type: {type_}")
    return _REGISTRY[type_]()


class FilterChain:
    """Ordered, stateful chain bound to one peer (ref RemoteNode)."""

    def __init__(self) -> None:
        self._filters: Dict[str, Filter] = {}

    def _get(self, type_: str) -> Filter:
        if type_ not in self._filters:
            self._filters[type_] = create(type_)
        return self._filters[type_]

    def encode(self, msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> Message:
        for spec in specs if specs is not None else msg.task.filters:
            msg = self._get(spec.type).encode(msg, spec)
        return msg

    def decode(self, msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> Message:
        chain: List[FilterSpec] = list(specs if specs is not None else msg.task.filters)
        for spec in reversed(chain):  # decode applies in reverse (ref van.cc)
            msg = self._get(spec.type).decode(msg, spec)
        return msg


_default_chain = FilterChain()


def encode_chain(msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> Message:
    return _default_chain.encode(msg, specs)


def decode_chain(msg: Message, specs: Optional[Sequence[FilterSpec]] = None) -> Message:
    return _default_chain.decode(msg, specs)


def _register_builtin() -> None:
    from . import add_noise, compressing, fixing_float, key_caching, sparse  # noqa: F401


_register_builtin()
