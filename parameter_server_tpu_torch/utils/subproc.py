"""A subprocess timeout that asks before it kills.

Counterpart of ``parameter_server_tpu/utils/subproc.py``.
``subprocess.run(timeout=...)`` kills its child outright; a child killed
while it holds the card (inside CUDA's initialisation, say)
runs no finalizer. :func:`run_graceful` sends SIGTERM first and waits a
grace period, so a responsive child exits cleanly; only then SIGKILL.
On any other exception the child is killed and reaped before the
exception propagates, as ``subprocess.run`` guarantees.

:data:`PROBE_CHILD_SRC` is a probe child's source (``python -c``): it
initialises the card (``torch.cuda.init()``, ``torch.cuda.device_count()``)
on a side thread and exits 0 when that worked, 1 when it raised.
"""

from __future__ import annotations

import subprocess


def run_graceful(argv, timeout_s: float, term_grace_s: float = 10.0,
                 capture_stdout: bool = False, **popen_kw) -> "tuple[int | None, bytes, bytes]":
    """Run ``argv`` to its end within ``timeout_s`` seconds.

    Returns ``(returncode, stderr_bytes, stdout_bytes)``; stdout is
    ``b""`` unless ``capture_stdout`` (else it goes to /dev/null, so a
    chatty child cannot fill an unread pipe). Past the timeout the child
    gets SIGTERM, ``term_grace_s`` seconds to exit, then SIGKILL, and
    ``subprocess.TimeoutExpired`` is raised with what the child wrote
    (``.output``, ``.stderr``)."""
    p = subprocess.Popen(
        argv,
        stdout=subprocess.PIPE if capture_stdout else subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        **popen_kw,
    )
    try:
        out, err = p.communicate(timeout=timeout_s)
        return p.returncode, err, out if capture_stdout else b""
    except subprocess.TimeoutExpired as te:
        # the grace sequence has its own guard: an exception raised in
        # this handler would escape the sibling one below and leave a
        # SIGTERM'd child unreaped
        try:
            p.terminate()
            try:
                out, err = p.communicate(timeout=term_grace_s)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
        except BaseException:
            p.kill()
            p.communicate()
            raise
        te.output = out if capture_stdout else b""
        te.stderr = err
        raise
    except BaseException:
        p.kill()
        p.communicate()
        raise


# The card's initialisation runs on a daemon thread: CPython runs signal
# handlers only between bytecodes of the main thread, and a main thread
# blocked in CUDA's initialisation could never run its SIGTERM
# handler. The main thread sleeps in short slices instead, so SIGTERM
# exits with 143 and runs the interpreter's finalizers.
PROBE_CHILD_SRC = (
    "import signal, sys, threading, time\n"
    "signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))\n"
    "done = []\n"
    "def _init():\n"
    "    try:\n"
    "        import torch\n"
    "        torch.cuda.init()\n"
    "        if torch.cuda.device_count() < 1:\n"
    "            raise RuntimeError('no CUDA device')\n"
    "        done.append(0)\n"
    "    except BaseException as e:\n"
    "        sys.stderr.write(repr(e) + '\\n')\n"
    "        done.append(1)\n"
    "t = threading.Thread(target=_init, daemon=True)\n"
    "t.start()\n"
    "while t.is_alive():\n"
    "    time.sleep(0.2)\n"
    "sys.exit(done[0] if done else 1)\n"
)
