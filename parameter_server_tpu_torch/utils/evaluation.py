"""Classification metrics (numpy), as in the JAX package's
``utils/evaluation.py``: labels in {-1, +1}, predictions are raw
margins Xw."""

from __future__ import annotations

import numpy as np


def auc(y: np.ndarray, xw: np.ndarray) -> float:
    """Area under ROC via the rank statistic, ties averaged."""
    y = np.asarray(y)
    xw = np.asarray(xw)
    pos = y > 0
    npos = int(pos.sum())
    nneg = len(y) - npos
    if npos == 0 or nneg == 0:
        return 1.0
    order = np.argsort(xw, kind="stable")
    sxw = xw[order]
    # average rank of each run of equal margins (1-based ranks)
    starts = np.flatnonzero(np.r_[True, sxw[1:] != sxw[:-1]])
    ends = np.r_[starts[1:], len(sxw)]
    run_rank = 0.5 * (starts + 1 + ends)
    ranks = np.empty(len(xw), dtype=np.float64)
    ranks[order] = np.repeat(run_rank, ends - starts)
    return float((ranks[pos].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def accuracy(y: np.ndarray, xw: np.ndarray, threshold: float = 0.0) -> float:
    """Fraction with sign(Xw - threshold) == sign(y)."""
    y = np.asarray(y)
    xw = np.asarray(xw)
    correct = ((xw > threshold) & (y > 0)) | ((xw <= threshold) & (y <= 0))
    return float(correct.mean()) if len(y) else 0.0


def logloss(y: np.ndarray, xw: np.ndarray) -> float:
    """Mean log(1 + exp(-y Xw))."""
    y = np.asarray(y, dtype=np.float64)
    xw = np.asarray(xw, dtype=np.float64)
    return float(np.mean(np.logaddexp(0.0, -y * xw))) if len(y) else 0.0


def rmse(y: np.ndarray, xw: np.ndarray) -> float:
    """Root mean squared error of the margins against the labels."""
    y = np.asarray(y, dtype=np.float64)
    xw = np.asarray(xw, dtype=np.float64)
    return float(np.sqrt(np.mean((y - xw) ** 2))) if len(y) else 0.0
