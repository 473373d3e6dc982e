"""An advisory inter-process lock on the one card.

Counterpart of ``parameter_server_tpu/utils/device_lock.py``. Two
processes that initialise the card at once (a watcher's probe and a run
of record, say) can fail or slow each other. Both sides take this
``flock`` around their use of the card; the kernel releases it when the
holder dies, so a held lock always means a live holder.

:func:`device_lock` yields a :class:`LockResult`, truthy when the lock
(or a parent's) is held, with a ``reason``: ``acquired``,
``held-by-parent``, ``busy`` (a live holder outlasted the wait) or
``unsupported`` (``flock`` impossible here; no exclusion exists). The
block runs either way: the caller chooses its policy from the reason.
``block_after_timeout=True`` keeps waiting past the bound instead of
running unlocked.

A holder's children must not take the lock again: a holder exports
``PS_DEVICE_LOCK_HELD=1`` (:func:`held_env`), under which
:func:`device_lock` does nothing and reports ``held-by-parent``.

Priority protocol: a process that needs the card now calls
:func:`request_priority` before it waits; cooperative background
holders poll :func:`foreign_priority` and step aside while a fresh
foreign request exists. The requester clears its marker
(:func:`clear_priority`); a crashed requester's marker ages out after
``PRIORITY_FRESH_S``. The marker changes who waits, never who may run.

The lock file is ``$PS_DEVICE_LOCK``, else ``ps_cuda_device.lock`` in
the temporary directory (``tempfile.gettempdir()``).
"""

from __future__ import annotations

import contextlib
import errno
import os
import sys
import tempfile
import time
from typing import Iterator

LOCK_ENV = "PS_DEVICE_LOCK"
HELD_ENV = "PS_DEVICE_LOCK_HELD"

#: the default wait: above the longest hold a cooperative holder makes
WAIT_ABOVE_LONGEST_HOLD_S = 5700.0

#: a priority request younger than this keeps cooperative holders away
#: (covers the requester's probe retries and inter-phase gaps; a crashed
#: requester's stale marker costs at most this much watcher idle time)
PRIORITY_FRESH_S = 1800.0


class LockResult:
    """Truthy iff the device is exclusively ours (or a parent's).

    ``reason``: "acquired" | "held-by-parent" | "busy" (live holder
    outlasted the wait) | "unsupported" (flock impossible on this
    filesystem — no exclusion exists to wait for)."""

    def __init__(self, acquired: bool, reason: str):
        self.acquired = acquired
        self.reason = reason

    def __bool__(self) -> bool:
        return self.acquired

    def __repr__(self) -> str:
        return f"LockResult({self.acquired}, {self.reason!r})"


def _lock_path() -> str:
    return os.environ.get(LOCK_ENV, os.path.join(tempfile.gettempdir(), "ps_cuda_device.lock"))


def _open_lock_file() -> "int | None":
    """Open (creating if needed) the lock file. The shared /tmp path is
    chmod'd world-writable so a second user can take the same lock; if
    another user's umask already made it unwritable for us, fall back
    to a per-uid path (loses cross-user exclusion). Returns None when
    no lock file can be opened at all (e.g. /tmp unwritable) — the
    caller reports "unsupported", never crashes the JSON contract."""
    path = _lock_path()
    try:
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
        with contextlib.suppress(OSError):
            os.chmod(path, 0o666)  # defeat the creator's umask
        return fd
    except OSError:
        try:
            fallback = f"{path}.{os.getuid()}"
            return os.open(fallback, os.O_CREAT | os.O_RDWR, 0o666)
        except OSError:
            return None


# -- priority requests ------------------------------------------------------

def _request_path() -> str:
    return _lock_path() + ".request"


def request_priority(note: str = "bench") -> None:
    """Mark that THIS process needs the device now. Cooperative
    background holders yield while the marker is fresh.
    Atomic write; never raises (a priority marker is best-effort).

    No-op when a parent already holds the flock for us (HELD_ENV): a
    holder's child asking for priority would make its own parent yield
    to it."""
    if os.environ.get(HELD_ENV):
        return
    path = _request_path()
    try:
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"{os.getpid()} {time.time():.0f} {note}\n")
        os.replace(tmp, path)
        with contextlib.suppress(OSError):
            os.chmod(path, 0o666)
    except OSError:
        pass


def clear_priority() -> None:
    """Remove OUR priority marker (a foreign one is left alone)."""
    path = _request_path()
    try:
        with open(path) as f:
            pid = int(f.read().split()[0])
        if pid == os.getpid():
            os.unlink(path)
    except (OSError, ValueError, IndexError):
        pass


def foreign_priority(
    fresh_s: float = PRIORITY_FRESH_S, ignore_pid: "int | None" = None
) -> "str | None":
    """A fresh priority request from ANOTHER process, or None.

    Returns a short human-readable description ("pid 123 note, 45s
    ago") for the yielding side's log. A marker from a dead pid is
    still honored while fresh — the requester may be a shell whose
    python child does the device work. ``ignore_pid`` lets a holder
    running a known child disregard that child's own marker (belt to
    request_priority's HELD_ENV suspenders — an older child binary
    without the no-op would otherwise still self-preempt)."""
    path = _request_path()
    try:
        with open(path) as f:
            parts = f.read().split(None, 2)
        pid = int(parts[0])
        stamp = float(parts[1])
        note = parts[2].strip() if len(parts) > 2 else "?"
    except (OSError, ValueError, IndexError):
        return None
    if pid == os.getpid() or pid == ignore_pid or os.environ.get(HELD_ENV):
        return None  # our own request (or our holder parent's/child's)
    age = time.time() - stamp
    # the marker stamp is written at whole-second precision, so a
    # just-written marker can read up to 0.5s "in the future"; allow a
    # small negative age, reject real clock skew
    if not (-60 <= age < fresh_s):
        return None  # stale (or clock-skewed far into the future)
    return f"pid {pid} ({note}), {age:.0f}s ago"


@contextlib.contextmanager
def device_lock(
    timeout_s: float = WAIT_ABOVE_LONGEST_HOLD_S,
    poll_s: float = 5.0,
    block_after_timeout: bool = False,
    priority_note: "str | None" = None,
) -> Iterator[LockResult]:
    """Hold the device flock for the enclosed block.

    Yields a truthy :class:`LockResult` when the lock was acquired (or
    a parent holds it); falsy with ``reason`` "busy"/"unsupported"
    otherwise — the block still runs either way, callers choose their
    policy from the reason (see module docstring).

    ``block_after_timeout=True``: when the wait bound expires, KEEP
    polling until the holder releases and take the lock then, instead
    of running unlocked (an unlocked run would collide with the next
    holder the moment the original one exits). The overrun is said on
    stderr each extra minute, so a wedged holder shows in the log.

    ``priority_note`` makes the wait a PRIORITY wait: the request
    marker is written on entry and re-written while polling (every
    ``PRIORITY_FRESH_S/3``), so it cannot age out under a wait longer
    than the freshness window — a stale marker would let the watcher
    win the flock race against the very caller the protocol
    prioritizes. The caller still owns clearing it (clear_priority)
    when its device need ends."""
    if os.environ.get(HELD_ENV):
        yield LockResult(True, "held-by-parent")
        return
    import fcntl

    fd = _open_lock_file()
    if fd is None:
        print(
            "device_lock: no lock file could be opened; "
            "no exclusion possible",
            file=sys.stderr,
        )
        yield LockResult(False, "unsupported")
        return
    res = LockResult(False, "busy")
    t0 = time.monotonic()
    warned_wait = False
    overrun_said = 0.0
    refreshed = time.monotonic()
    if priority_note is not None:
        request_priority(priority_note)
    try:
        while True:
            if (priority_note is not None
                    and time.monotonic() - refreshed > PRIORITY_FRESH_S / 3):
                request_priority(priority_note)
                refreshed = time.monotonic()
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                res = LockResult(True, "acquired")
                break
            except OSError as e:
                if e.errno not in (errno.EWOULDBLOCK, errno.EAGAIN,
                                   errno.EACCES):
                    # flock unsupported here (e.g. ENOLCK on NFS):
                    # exclusion is impossible — say so once, don't spin
                    print(
                        f"device_lock: flock unavailable ({e}); "
                        "no exclusion possible",
                        file=sys.stderr,
                    )
                    res = LockResult(False, "unsupported")
                    break
                waited = time.monotonic() - t0
                if waited >= timeout_s:
                    if not block_after_timeout:
                        if timeout_s > 0:
                            print(
                                f"device_lock: holder outlived the "
                                f"{timeout_s:.0f}s wait",
                                file=sys.stderr,
                            )
                        break
                    if waited - overrun_said >= 60.0:
                        print(
                            f"device_lock: holder past the "
                            f"{timeout_s:.0f}s bound ({waited:.0f}s); "
                            "still waiting to acquire (will not run "
                            "unlocked)",
                            file=sys.stderr,
                        )
                        overrun_said = waited
                elif not warned_wait:
                    # a silent multi-minute block is indistinguishable
                    # from a wedge — say what we're doing, once
                    print(
                        "device_lock: device held by another process; "
                        f"waiting up to {timeout_s:.0f}s",
                        file=sys.stderr,
                    )
                    warned_wait = True
                time.sleep(poll_s)
        yield res
    finally:
        try:
            if res.acquired:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


def held_env() -> dict:
    """Environment for children of a lock holder (no re-acquire)."""
    env = dict(os.environ)
    env[HELD_ENV] = "1"
    return env
