"""Local file access for data readers and model writers.

Counterpart of the local-path part of ``parameter_server_tpu/utils/file.py``:
gzip by extension, parent directories made on write, and the reference's
data-file patterns (shell glob first, then an anchored regex over the
basename, as the reference's ``searchFiles`` matches ``part.*``). Remote
paths (``hdfs://`` and the like) raise ``NotImplementedError``: the
filesystem registry is not ported.
"""

from __future__ import annotations

import glob as _glob
import gzip
import os
import re
from typing import IO, Iterable, Iterator, List


def is_remote(path: str) -> bool:
    return "://" in path


def _local(path: str) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r}: the PyTorch package reads local files only"
        )
    return path


def open_read(path: str, mode: str = "rt") -> IO:
    if _local(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def open_write(path: str, mode: str = "w") -> IO:
    """Open for writing, creating parent directories first."""
    os.makedirs(os.path.dirname(os.path.abspath(_local(path))), exist_ok=True)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def expand_globs(patterns: Iterable[str]) -> List[str]:
    """Expand data-file patterns: a shell glob, else a file of that
    name, else the basename as an anchored regex over its directory."""
    out: List[str] = []
    for p in patterns:
        hits = sorted(_glob.glob(_local(p)))
        if not hits and os.path.exists(p):
            hits = [p]
        if not hits:
            dirname, base = os.path.split(p)
            try:
                rx = re.compile(base)
                d = dirname or "."
                if os.path.isdir(d):
                    hits = sorted(
                        os.path.join(dirname, f) if dirname else f
                        for f in os.listdir(d)
                        if rx.fullmatch(f)
                    )
            except re.error:
                pass
        out.extend(hits)
    return out


def read_lines(path: str) -> Iterator[str]:
    """Non-empty lines of a (possibly gzipped) text file, newline stripped."""
    with open_read(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                yield line
