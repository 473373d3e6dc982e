"""File access for data readers and model writers, local and remote.

Counterpart of ``parameter_server_tpu/utils/file.py`` (the reference's
``util/file.{h,cc}`` and ``hdfs.h``): gzip by extension, parent
directories made on write, the reference's data-file patterns (shell
glob first, then an anchored regex over the basename, as the
reference's ``searchFiles`` matches ``part.*``), and a registry of
remote filesystems. A remote path (``scheme://...``) goes to the adapter
registered for its scheme (:func:`register_filesystem`) in
:func:`open_read`, :func:`open_write` and :func:`expand_globs`; gzip is
layered on top. :class:`HadoopCliFS` shells out to ``hadoop fs`` as the
reference does (``-cat`` / ``-put -`` / ``-ls``, with ``-D
fs.default.name=<namenode> -D hadoop.job.ugi=<ugi>``). A scheme with no
adapter raises ``NotImplementedError`` on open (and a pattern of one
passes through :func:`expand_globs` untouched), as in the JAX package.
"""

from __future__ import annotations

import glob as _glob
import gzip
import io
import os
import re
import subprocess
from typing import IO, Dict, Iterable, Iterator, List, Optional

_REMOTE_FS: Dict[str, "RemoteFS"] = {}


class RemoteFS:
    """The adapter of a remote scheme: streaming reads and writes of
    bytes, and the files a pattern lists."""

    def open_read(self, path: str) -> IO[bytes]:
        raise NotImplementedError

    def open_write(self, path: str) -> IO[bytes]:
        raise NotImplementedError

    def list(self, pattern: str) -> List[str]:
        raise NotImplementedError


def register_filesystem(scheme: str, fs: Optional[RemoteFS]) -> None:
    """Register (or, with None, remove) the adapter of ``scheme://``."""
    if fs is None:
        _REMOTE_FS.pop(scheme, None)
    else:
        _REMOTE_FS[scheme] = fs


def get_filesystem(path_or_scheme: str) -> Optional[RemoteFS]:
    """The adapter of a path's scheme (or of a bare scheme), or None."""
    scheme = path_or_scheme.split("://", 1)[0] if "://" in path_or_scheme else path_or_scheme
    return _REMOTE_FS.get(scheme)


class HadoopCliFS(RemoteFS):
    """The ``hadoop fs`` client as an adapter: ``-cat`` reads, ``-put -``
    writes, ``-ls`` lists. ``home`` (default ``$HADOOP_HOME``),
    ``namenode`` and ``ugi`` are the reference's HDFSConfig fields;
    ``binary`` names the executable outright."""

    def __init__(self, home: str = "", namenode: str = "", ugi: str = "",
                 binary: Optional[str] = None):
        self.home = home or os.environ.get("HADOOP_HOME", "")
        self.namenode = namenode
        self.ugi = ugi
        self._binary = binary

    def _cmd(self) -> List[str]:
        if self._binary:
            cmd = [self._binary, "fs"]
        elif self.home:
            cmd = [os.path.join(self.home, "bin", "hadoop"), "fs"]
        else:
            cmd = ["hadoop", "fs"]
        if self.namenode:
            cmd += ["-D", f"fs.default.name={self.namenode}"]
        if self.ugi:
            cmd += ["-D", f"hadoop.job.ugi={self.ugi}"]
        return cmd

    def open_read(self, path: str) -> IO[bytes]:
        proc = subprocess.Popen(self._cmd() + ["-cat", path], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return _ProcReader(proc, path)

    def open_write(self, path: str) -> IO[bytes]:
        proc = subprocess.Popen(self._cmd() + ["-put", "-", path], stdin=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return _ProcWriter(proc, path)

    def list(self, pattern: str) -> List[str]:
        out = subprocess.run(self._cmd() + ["-ls", pattern], capture_output=True, text=True)
        if out.returncode != 0:
            return []
        files = []
        for line in out.stdout.splitlines():
            # an `-ls` line ends with the path (the reference takes the
            # token after the last space)
            parts = line.split()
            if parts and "://" in parts[-1] or (parts and parts[-1].startswith("/")):
                files.append(parts[-1])
        return sorted(files)


class _ProcReader(io.RawIOBase):
    """A file over a subprocess's stdout; ``close`` raises ``IOError``
    when the process exits non-zero."""

    def __init__(self, proc: subprocess.Popen, path: str):
        self._proc = proc
        self._path = path

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        chunk = self._proc.stdout.read(len(b))
        if not chunk:
            return 0
        b[: len(chunk)] = chunk
        return len(chunk)

    def close(self) -> None:
        if self.closed:
            return
        self._proc.stdout.close()
        code = self._proc.wait()
        err = self._proc.stderr.read().decode(errors="replace")
        self._proc.stderr.close()
        super().close()
        if code != 0:
            raise IOError(f"remote read failed ({code}) for {self._path}: {err.strip()}")


class _ProcWriter(io.RawIOBase):
    """A file over a subprocess's stdin; ``close`` raises ``IOError``
    when the process exits non-zero."""

    def __init__(self, proc: subprocess.Popen, path: str):
        self._proc = proc
        self._path = path

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._proc.stdin.write(b)
        return len(b)

    def close(self) -> None:
        if self.closed:
            return
        self._proc.stdin.close()
        code = self._proc.wait()
        err = self._proc.stderr.read().decode(errors="replace")
        self._proc.stderr.close()
        super().close()
        if code != 0:
            raise IOError(f"remote write failed ({code}) for {self._path}: {err.strip()}")


def is_remote(path: str) -> bool:
    return "://" in path


def _remote(path: str) -> RemoteFS:
    fs = get_filesystem(path)
    if fs is None:
        raise NotImplementedError(
            f"no filesystem registered for {path!r}: register one with "
            "utils.file.register_filesystem (HadoopCliFS for hdfs://)")
    return fs


def open_read(path: str, mode: str = "rt") -> IO:
    if is_remote(path):
        raw = _remote(path).open_read(path)
        if path.endswith(".gz"):
            raw = gzip.open(raw, "rb")
        if "b" not in mode:
            return io.TextIOWrapper(io.BufferedReader(raw) if isinstance(raw, io.RawIOBase) else raw)
        return raw
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def open_write(path: str, mode: str = "w") -> IO:
    """Open for writing, creating parent directories first (a local path)."""
    if is_remote(path):
        raw = _remote(path).open_write(path)
        if path.endswith(".gz"):
            return gzip.open(raw, "wb")
        if "b" not in mode:
            return io.TextIOWrapper(io.BufferedWriter(raw) if isinstance(raw, io.RawIOBase) else raw)
        return raw
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def expand_globs(patterns: Iterable[str]) -> List[str]:
    """Expand data-file patterns: a shell glob, else a file of that
    name, else the basename as an anchored regex over its directory. A
    remote pattern lists through its scheme's adapter, and passes through
    as it is when none is registered or the listing is empty."""
    out: List[str] = []
    for p in patterns:
        if is_remote(p):
            fs = get_filesystem(p)
            hits = fs.list(p) if fs is not None else []
            out.extend(hits if hits else [p])
            continue
        hits = sorted(_glob.glob(p))
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
