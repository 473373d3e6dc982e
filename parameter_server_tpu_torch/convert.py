"""Carry optimizer state and LM parameters between the JAX package and the port.

The JAX worker's ``state_host()["state"]`` is a dict of numpy arrays
(``{"z", "sqrt_n"}`` for FTRL; a bf16 ``sqrt_n`` arrives as an
``ml_dtypes.bfloat16`` array). :func:`state_from_jax` turns it into the
port's dict of tensors, :func:`state_to_numpy` goes back.
:func:`lm_params_from_jax` and :func:`lm_params_to_numpy` do the same for
the JAX ``init_lm`` parameter dict, checking names and shapes against
the config, :func:`darlin_state_from_jax` and
:func:`darlin_state_to_numpy` for a darlin solver's blocks and dual, and
:func:`kv_replica_from_jax` and :func:`kv_replica_to_numpy` for a
KVVector's tables (``get_replica()``: channel → ``[P, k]`` array).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":  # ml_dtypes array: move the raw bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def state_from_jax(np_state: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """numpy state dict -> tensors on ``device`` (CUDA by default). The
    tensors own their memory: the port updates state in place."""
    dev = resolve(device)
    return {k: _to_tensor(v).to(dev) for k, v in np_state.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """tensors -> numpy state dict. bf16 tensors come back as
    ``ml_dtypes.bfloat16`` arrays when that package is installed (the
    JAX package's own form), else widened exactly to float32."""
    out = {}
    for k, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                out[k] = t.to(torch.float32).numpy()
            else:
                out[k] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = t.numpy().copy()
    return out


def _lm_shapes(cfg) -> Dict[str, tuple]:
    d, kv_w = cfg.d_model, cfg.kv_heads * cfg.head_dim
    shapes = {"emb": (cfg.vocab, d), "ln_f": (d,)}
    for i in range(cfg.n_layers):
        shapes.update({f"l{i}/ln1": (d,), f"l{i}/ln2": (d,), f"l{i}/wq": (d, d),
                       f"l{i}/wk": (d, kv_w), f"l{i}/wv": (d, kv_w), f"l{i}/wo": (d, d),
                       f"l{i}/w1": (d, cfg.d_ff), f"l{i}/w2": (cfg.d_ff, d)})
    return shapes


def lm_params_from_jax(np_params: Dict[str, np.ndarray], cfg, device=None) -> Dict[str, torch.Tensor]:
    """The JAX ``init_lm`` dict (``emb``, ``ln_f``, ``l{i}/ln1|ln2|wq|wk|
    wv|wo|w1|w2``, numpy arrays) -> the port's float32 parameters on
    ``device`` (CUDA by default; raises without a card). Raises on a
    missing, extra or misshapen entry for ``cfg`` (a
    :class:`..models.transformer.LMConfig`)."""
    dev = resolve(device)
    shapes = _lm_shapes(cfg)
    if set(np_params) != set(shapes):
        raise ValueError(f"LM parameters do not match the config: missing "
                         f"{sorted(set(shapes) - set(np_params))}, extra "
                         f"{sorted(set(np_params) - set(shapes))}")
    out = {}
    for k, shape in shapes.items():
        arr = np.asarray(np_params[k], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"LM parameter {k}: shape {arr.shape}, config wants {shape}")
        out[k] = _to_tensor(arr).to(dev)
    return out


def lm_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's LM parameters -> the JAX package's numpy dict."""
    return state_to_numpy(params)


def darlin_state_from_jax(np_state: Dict[str, np.ndarray], blocks, device=None) -> Dict[str, object]:
    """A darlin solver's state as numpy arrays -> the port's form
    (``DarlinSolver.set_state``): ``{"w", "delta", "active"}``, each a
    ``[num_cols]`` array over all columns (the JAX solver's ``w``,
    ``delta`` and ``active`` properties), cut into one tensor a feature
    block of ``blocks``, and ``"dual"`` (the JAX solver's ``[1, n]`` dual
    or a flat ``[n]``) as one ``[n]`` tensor, all on ``device`` (CUDA by
    default)."""
    dev = resolve(device)
    out: Dict[str, object] = {}
    for key in ("w", "delta", "active"):
        arr = np.asarray(np_state[key])
        out[key] = [_to_tensor(arr[b.col_range.begin:b.col_range.end]).to(dev) for b in blocks]
    out["dual"] = _to_tensor(np.asarray(np_state["dual"], np.float32).reshape(-1)).to(dev)
    return out


def darlin_state_to_numpy(state: Dict[str, object], blocks, num_cols: int) -> Dict[str, np.ndarray]:
    """The port's darlin state (``DarlinSolver.state``) -> numpy arrays:
    ``w``, ``delta`` and ``active`` over all ``num_cols`` columns (the
    blocks' ranges filled, ``w`` 0, ``delta`` 0 and ``active`` False
    elsewhere) and the flat ``[n]`` dual."""
    out = {}
    for key, dtype in (("w", np.float32), ("delta", np.float32), ("active", bool)):
        arr = np.zeros(num_cols, dtype)
        for b, t in zip(blocks, state[key]):
            arr[b.col_range.begin:b.col_range.end] = t.detach().cpu().numpy()
        out[key] = arr
    out["dual"] = state["dual"].detach().cpu().numpy().copy()
    return out


def kv_replica_from_jax(snapshot: Dict[int, np.ndarray], device=None) -> Dict[int, torch.Tensor]:
    """A JAX ``KVVector.get_replica()`` dict (channel → numpy ``[P, k]``)
    as the port's ``set_replica`` input: tensors on ``device`` (the CUDA
    device unless named), bits unchanged."""
    dev = resolve(device)
    return {int(ch): _to_tensor(np.asarray(arr)).to(dev) for ch, arr in snapshot.items()}


def kv_replica_to_numpy(snapshot: Dict[int, torch.Tensor]) -> Dict[int, np.ndarray]:
    """The inverse: channel → host numpy array (a JAX ``set_replica``
    input)."""
    return {int(ch): (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).copy()
            for ch, t in snapshot.items()}
