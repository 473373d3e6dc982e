"""Node/data assignment (ref ``src/system/assigner.{h,cc}``).

``NodeAssigner`` hands out ranks and server key ranges; ``DataAssigner``
partitions input files (or byte ranges of a single file) over workers,
matching the reference's file-count vs even-divide logic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..utils import file as psfile
from ..utils.range import Range
from .manager import Node


class NodeAssigner:
    def __init__(self, num_servers: int, key_range: Optional[Range] = None):
        self.num_servers = num_servers
        self.key_range = key_range if key_range is not None else Range.all()
        self._server_rank = 0
        self._worker_rank = 0

    def assign(self, node: Node) -> Node:
        if node.role == Node.SERVER:
            node.key_range = self.key_range.even_divide(
                self.num_servers, self._server_rank
            )
            node.rank = self._server_rank
            self._server_rank += 1
        elif node.role == Node.WORKER:
            node.rank = self._worker_rank
            self._worker_rank += 1
        return node


@dataclasses.dataclass
class DataPart:
    """One worker's share: a file list, or a (file, example-range) slice."""

    files: List[str]
    range_begin: int = 0
    range_end: int = 0  # 0 = whole files


class DataAssigner:
    """Partition files over ``num`` consumers (ref DataAssigner::set/next).

    With at least ``num`` files, files are dealt round-robin (the reference
    evenly divides the file list); with fewer files, each file is split by
    example ranges.
    """

    def __init__(self, files: Optional[List[str]] = None, num: int = 0, local: bool = False):
        self._parts: List[DataPart] = []
        self._pos = 0
        if files is not None and num > 0:
            self.set(files, num, local)

    def set(self, files: List[str], num: int, local: bool = False) -> None:
        files = psfile.expand_globs(files)
        self._parts = []
        self._pos = 0
        if not files:
            return
        if len(files) >= num:
            full = Range(0, len(files))
            for i in range(num):
                r = full.even_divide(num, i)
                self._parts.append(DataPart(files=files[r.begin : r.end]))
        else:
            # fewer files than consumers: split by example range per file
            per_file = -(-num // len(files))
            for i in range(num):
                f = files[i % len(files)]
                slot = i // len(files)
                self._parts.append(
                    DataPart(files=[f], range_begin=slot, range_end=per_file)
                )
        del local  # reference uses it to pin local shards; mesh handles placement

    def next(self) -> Optional[DataPart]:
        if self._pos >= len(self._parts):
            return None
        part = self._parts[self._pos]
        self._pos += 1
        return part

    @property
    def cur_id(self) -> int:
        return self._pos

    def size(self) -> int:
        return len(self._parts)
