"""Checkpoints: save and restore trees of tensors in a directory.

Counterpart of ``parameter_server_tpu/parameter/replica.py``'s
``CheckpointManager`` in its NumPy format (the JAX package writes with
orbax where orbax is installed and falls back to this format): step
``N`` lives in ``step_{N:010d}/arrays.npz``, the tree's leaves as
positional arrays ``arr_0``, ``arr_1``, ... beside ``__treedef__`` (the
tree's structure as text, for a reader; restore takes the structure
from its template). A tree is a nest of dicts (in sorted-key order, as
``jax.tree.flatten`` orders a dict), lists and tuples over leaves:
tensors (saved from the host, restored onto the template's device),
numpy arrays and Python numbers; ``None`` holds no leaf. So a params-only
dict saved by either package restores in the other. A bfloat16 leaf is
written widened to float32 (exact); a bfloat16 leaf of the JAX package's
checkpoints arrives as a 2-byte void array, and both restore into a
bfloat16 template bit for bit.

A write goes to ``step_N.tmp`` and is renamed into place; the
``checkpoint.write`` fault point (:mod:`..system.faults`) fires between
the two, where a crash can leave only a torn ``.tmp`` that
:meth:`CheckpointManager.latest_step` never lists.

:class:`ReplicaManager` keeps in-memory replicas of parameters (host
copies of their ``get_replica`` snapshots, by name), backs them up by
hand, consistently under a live push stream, or periodically on a
thread, and installs one back (``recover``), through the store's
executor when pushes may still be in flight.

:class:`Checkpointable` is the save / restore mixin over a component's
``state_host()`` / ``load_state_host(snapshot)`` pair (the SGD-family
workers through ``ISGDCompNode``, and ``NNTrainer``).
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..system import faults

_LOG = logging.getLogger(__name__)

def _leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _structure(tree: Any) -> str:
    """The tree's structure as text, ``*`` for a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    return "*"


def _is_bf16(dtype) -> bool:
    """A torch bfloat16 or an ``ml_dtypes.bfloat16`` numpy dtype."""
    return dtype == torch.bfloat16 or getattr(dtype, "name", "") == "bfloat16"


def _host(leaf: Any, copy: bool) -> np.ndarray:
    """A leaf as the numpy array that is written. A bfloat16 leaf (a
    tensor, or an ``ml_dtypes`` array) is widened exactly to float32:
    numpy has no bfloat16 of its own, ``np.savez`` would write an
    ``ml_dtypes`` array as a 2-byte void that only its bits describe, and
    the JAX package's npz restore refuses such a leaf. Restore narrows it
    back into a bfloat16 template bit for bit."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy() if copy else t.cpu().numpy()
    arr = np.asarray(leaf)
    if _is_bf16(arr.dtype):
        return arr.astype(np.float32)
    return np.array(leaf) if copy else arr


def _leaf_like(tmpl: Any, arr: np.ndarray, name: str) -> Any:
    """The saved array ``arr`` in the form of the template leaf ``tmpl``.

    A 2-byte void array is a bfloat16 leaf as ``np.savez`` writes an
    ``ml_dtypes`` array (the JAX package's checkpoints where its leaves
    are bf16): its raw bits go into a bfloat16 template unchanged. A void
    leaf of another width, or under a template that is not bfloat16,
    raises ``ValueError`` naming the leaf: it is never cast."""
    if arr.dtype.kind == "V":
        tdtype = tmpl.dtype if isinstance(tmpl, (torch.Tensor, np.ndarray, np.generic)) else None
        if arr.dtype.itemsize != 2 or tdtype is None or not _is_bf16(tdtype):
            raise ValueError(
                f"checkpoint leaf {name!r} is a {arr.dtype.itemsize}-byte void array (dtype "
                f"{arr.dtype.str}) under a template of {tdtype or type(tmpl).__name__}; only "
                "a 2-byte (bfloat16) leaf restores, into a bfloat16 template")
        bits = np.ascontiguousarray(arr).view(np.int16)
        if isinstance(tmpl, torch.Tensor):
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(tmpl.device)
        return bits.view(tdtype)
    if isinstance(tmpl, torch.Tensor):
        # a float32 leaf widened from bfloat16 narrows back exactly
        return torch.from_numpy(np.array(arr)).to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray) and _is_bf16(tmpl.dtype):
        return arr.astype(tmpl.dtype)
    if isinstance(tmpl, (bool, int, float)) and not isinstance(tmpl, np.generic):
        return type(tmpl)(arr)
    return arr


def _rebuild(tmpl: Any, arrays, name: str = "") -> Any:
    """``tmpl``'s structure with its leaves taken in order from the
    iterator ``arrays``; ``name`` is the leaf's path, for errors."""
    if tmpl is None:
        return None
    if isinstance(tmpl, dict):  # leaves in sorted-key order, keys in the template's
        out = {k: _rebuild(tmpl[k], arrays, f"{name}/{k}") for k in sorted(tmpl)}
        return {k: out[k] for k in tmpl}
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_rebuild(t, arrays, f"{name}/{i}") for i, t in enumerate(tmpl))
    return _leaf_like(tmpl, next(arrays), name or "/")


class Checkpointable:
    """Durable checkpoint/restore over the ``state_host`` /
    ``load_state_host`` hook pair: anything exposing both gets
    ``checkpoint``, ``checkpoint_async`` and ``restore``."""

    def checkpoint(self, manager: "CheckpointManager", step: int) -> str:
        """Save the whole ``state_host`` snapshot as step ``step``."""
        return manager.save(step, self.state_host())

    def checkpoint_async(self, manager: "CheckpointManager", step: int) -> str:
        """Save the ``state_host`` snapshot on a thread (the manager takes
        owned copies before returning); call ``manager.wait()`` before
        exit."""
        return manager.save_async(step, self.state_host())

    def restore(self, manager: "CheckpointManager", step: Optional[int] = None) -> int:
        """Load the latest (or the given) step through ``load_state_host``,
        with this component's own snapshot as the template; returns the
        step."""
        if step is None:
            step = manager.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {manager.directory}")
        self.load_state_host(manager.restore(step, like=self.state_host()))
        return step


class CheckpointManager:
    """Save/restore trees of tensors under ``directory``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _write(self, path: str, flat: List[np.ndarray], structure: str) -> None:
        # under a .tmp name, then renamed: a crash, or a writer thread
        # killed at interpreter exit, leaves only a step_*.tmp dir, which
        # latest_step's int() parse skips
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), *flat,
                 __treedef__=np.frombuffer(structure.encode(), dtype=np.uint8))
        # die mid-write: the tmp dir written, the rename not done
        faults.inject("checkpoint.write", detail=path)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    def save(self, step: int, tree: Any) -> str:
        """Write ``tree`` as step ``step``, after any save in flight."""
        self.wait()
        path = self._step_dir(step)
        self._write(path, [_host(x, copy=False) for x in _leaves(tree)], _structure(tree))
        return path

    def save_async(self, step: int, tree: Any) -> str:
        """Take the host snapshot now (owned copies: the caller may change
        its tensors in place at the next step), then write it on a thread
        while training goes on. Saves run one at a time; a failed write
        re-raises from the next ``save``, ``save_async`` or :meth:`wait`,
        which the caller runs before it exits."""
        self.wait()
        path = self._step_dir(step)
        flat = [_host(x, copy=True) for x in _leaves(tree)]
        t = threading.Thread(target=self._write_guarded, args=(path, flat, _structure(tree)),
                             name=f"ckpt-save-{step}", daemon=True)
        self._pending = t
        t.start()
        return path

    def _write_guarded(self, path: str, flat, structure: str) -> None:
        try:
            self._write(path, flat, structure)
        except BaseException as e:  # surfaced by the next wait()
            self._async_error = e

    def wait(self) -> None:
        """Drain the save in flight, re-raising its failure."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._async_error is not None:
            e, self._async_error = self._async_error, None
            raise RuntimeError("async checkpoint save failed (the checkpoint at the failed step "
                               "is incomplete on disk)") from e

    def restore(self, step: int, like: Any = None) -> Any:
        """Step ``step`` in the structure of ``like``: tensors onto the
        template leaf's device and dtype, Python numbers as their type,
        numpy arrays as saved (a bfloat16 template's leaf back in
        bfloat16, from a float32 or a 2-byte void leaf, bit for bit).
        Raises ``ValueError`` when the counts of leaves differ, or for a
        void leaf that is not a bfloat16 template's."""
        self.wait()  # a save in flight may be writing this step
        path = self._step_dir(step)
        if like is None:
            raise ValueError("the npz checkpoint format restores into a template: pass like=")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = [data[k] for k in data.files if k != "__treedef__"]
        n_leaves = len(_leaves(like))
        if n_leaves != len(arrays):
            raise ValueError(f"checkpoint at {path} holds {len(arrays)} arrays where the "
                             f"template expects {n_leaves} leaves — saved with a different "
                             "model/optimizer config?")
        return _rebuild(like, iter(arrays))

    def latest_step(self) -> Optional[int]:
        """The largest saved step, or None."""
        self.wait()  # a step being written must not be listed
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return max(steps) if steps else None


class ReplicaManager:
    """In-memory replicas (ref kReplicaGroup / kOwnerGroup): each
    parameter's snapshot is kept by name so a replacement can
    ``recover`` it.

    Two backup paths:

    - :meth:`backup`: ``get_replica``'s drain-then-copy, safe only once
      the caller has stopped its own submissions;
    - :meth:`backup_consistent`: a snapshot through the store's executor
      (``get_replica_consistent``: one submitted copy step a channel), so
      a live push stream cannot tear it, with the **barrier**
      timestamps that say which pushes are inside it (every step with a
      lower timestamp): the replay contract of the recovery drill.

    :meth:`start_periodic` runs ``backup_consistent`` on a thread. Every
    map below is guarded (the periodic thread races a ``recover`` from
    the recovery coordinator's poll thread); the snapshot is taken
    outside the lock, so a slow store never blocks the recovery of
    another parameter.
    """

    def __init__(self) -> None:
        self._replicas: Dict[str, dict] = {}  # guarded-by: _lock
        #: per name: {"barrier": {ch: ts}, "version", "at" (wall clock),
        #: "consistent" (which path took it)}
        self._meta: Dict[str, dict] = {}  # guarded-by: _lock
        self._periodic: Dict[str, Tuple[threading.Thread, threading.Event]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _store(self, name: str, snap: dict, barrier: Dict[int, int], consistent: bool) -> None:
        with self._lock:
            self._replicas[name] = snap
            prev = self._meta.get(name)
            self._meta[name] = {
                "barrier": dict(barrier),
                "version": (prev["version"] + 1) if prev else 1,
                "at": time.time(),
                "consistent": consistent,
            }

    def backup(self, parameter) -> None:
        """Snapshot by ``get_replica`` (drains the executor, then copies:
        the caller must not be submitting meanwhile)."""
        self._store(parameter.name, parameter.get_replica(), {}, False)

    def backup_consistent(self, parameter) -> dict:
        """Snapshot through the store's executor, safe under a concurrent
        push stream; returns the stored metadata with the per-channel
        barrier timestamps."""
        snap, barrier = parameter.get_replica_consistent()
        self._store(parameter.name, snap, barrier, True)
        return self.meta(parameter.name)

    def recover(self, parameter, through_executor: bool = False,
                timeout: Optional[float] = 60.0) -> bool:
        """Install the last snapshot; False if there is none.
        ``through_executor`` submits the install as a store step, in
        timestamp order with the pushes in flight (the live-crash path),
        after telling a migration in flight that its snapshot is stale
        (``note_external_restore``); the wait is bounded by ``timeout``
        (None: no bound), so a store wedged by the failure being
        recovered raises on the coordinator's thread instead of hanging
        it. The default installs directly (a quiesced caller)."""
        with self._lock:
            snap = self._replicas.get(parameter.name)
        if snap is None:
            return False
        if through_executor and hasattr(parameter, "submit"):
            if hasattr(parameter, "note_external_restore"):
                parameter.note_external_restore()
            ts = parameter.submit(lambda: parameter.recover(snap), parameter.request())
            parameter.executor.wait(ts, timeout=timeout)
        else:
            parameter.recover(snap)
        return True

    def barrier(self, name: str) -> Dict[int, int]:
        """Per-channel executor timestamps of the last snapshot: a push
        with a lower timestamp is in it, a higher one is not (and is
        replayed after a recover)."""
        with self._lock:
            meta = self._meta.get(name)
            return dict(meta["barrier"]) if meta else {}

    def meta(self, name: str) -> Optional[dict]:
        with self._lock:
            m = self._meta.get(name)
            return dict(m) if m else None

    def drop(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
            self._meta.pop(name, None)

    # -- the periodic backup loop --

    def start_periodic(self, parameter, interval_s: float = 30.0) -> None:
        """Back ``parameter`` up every ``interval_s`` on a thread (the
        consistent path); one loop a name, :meth:`stop_periodic` stops
        and joins it. A failed backup logs and retries at the next tick;
        the previous snapshot stays (the swap is one guarded store)."""
        name = parameter.name
        stop = threading.Event()

        def loop() -> None:
            while not stop.wait(interval_s):
                try:
                    self.backup_consistent(parameter)
                except Exception:
                    _LOG.exception("periodic replica backup of %r failed; keeping the previous "
                                   "snapshot and retrying next tick", name)

        t = threading.Thread(target=loop, name=f"replica-backup:{name}", daemon=True)
        with self._lock:
            if name in self._periodic:
                raise RuntimeError(f"periodic backup of {name!r} already running")
            self._periodic[name] = (t, stop)
        t.start()

    def stop_periodic(self, name: Optional[str] = None) -> None:
        """Stop and join one parameter's backup loop, or all of them."""
        with self._lock:
            if name is None:
                entries = list(self._periodic.items())
                self._periodic.clear()
            else:
                e = self._periodic.pop(name, None)
                entries = [(name, e)] if e else []
        for _, (t, stop) in entries:
            stop.set()
            t.join(timeout=30)
