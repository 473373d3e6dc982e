"""The headline configuration of the main path, shared by the scripts
that drive it on the card (``chip_smoke.py``, :mod:`.profile_step`).

It is ``bench.py run_synthetic``'s workload on the exact wire: online
FTRL sparse logistic regression, α=0.1, β=1, L1=1, a 2^22-slot hashed
table, 16384-row minibatches of 39 binary keys drawn from 2^24, labels
from the share of low-id keys in the row, ``update="sparse"``, T=8
minibatches per launch, τ=0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..apps.linear.async_sgd import prep_batch_shared
from ..apps.linear.config import Config, LearningRateConfig, PenaltyConfig, SGDConfig
from ..ops.kv_ops import localize
from ..parameter.parameter import KeyDirectory
from ..utils.sparse import SparseBatch, random_sparse

SLOTS = 1 << 22
MB, NNZ, KEYS, T = 16384, 39, 1 << 24, 8
ALPHA, BETA, L1 = 0.1, 1.0, 1.0


def make_batch(seed: int) -> SparseBatch:
    """bench.py's synthetic batch for ``seed``: the same keys, labels
    from the share of low-id keys in the row. The generator's own labels
    are replaced, so it is given a zero weight vector instead of drawing
    one over all 2^24 keys."""
    b = random_sparse(MB, KEYS, NNZ, seed=seed, binary=True,
                      w_true=np.zeros(KEYS, np.float32))
    b.y = np.where(
        (b.indices.reshape(MB, -1) % 1024 < 256).mean(1) > 0.24, 1.0, -1.0
    ).astype(np.float32)
    return b


def conf(update: str = "sparse", dtype: str = "float32", steps: int = T) -> Config:
    """The headline worker config; ``update``, the √n storage type and
    the minibatches per launch vary for the side paths."""
    c = Config()
    c.penalty = PenaltyConfig(type="l1", lambda_=[L1])
    c.learning_rate = LearningRateConfig(type="decay", alpha=ALPHA, beta=BETA)
    c.async_sgd = SGDConfig(
        algo="ftrl", minibatch=MB, num_slots=SLOTS, max_delay=0,
        update=update, ftrl_state_dtype=dtype, steps_per_launch=steps,
    )
    return c


def ell_conf() -> Config:
    """The headline configuration for the AdaGrad ELL workers (FM and
    wide&deep): the same penalty, rate, table and minibatches, the 39
    keys of a row as its ELL lanes."""
    c = conf()
    c.async_sgd = SGDConfig(algo="standard", minibatch=MB, num_slots=SLOTS, ell_lanes=NNZ,
                            rows_pad=MB)
    return c


def sparse_update_inputs(seed: int, gen: torch.Generator, device: str = "cuda"):
    """The sparse FTRL update's inputs on a real headline batch: ``rel``
    and ``ok`` of its deduplicated, padded slot vector (``localize``,
    sentinel tail included; sorted, as ``np.unique`` leaves it) and a
    gradient ``g_u`` from ``gen`` on its real slots."""
    batch = make_batch(seed)
    nnz_pad = max(4096, -(-int(batch.nnz * 1.25) // 4096) * 4096)
    uniq = -(-min(nnz_pad, SLOTS) // 1024) * 1024
    pb = prep_batch_shared(batch, KeyDirectory(SLOTS), 1, MB, nnz_pad, uniq, SLOTS)
    rel, ok = localize(torch.as_tensor(pb.uslots[0]).to(device), SLOTS)
    g_u = torch.randn(uniq, device=device, generator=gen) * torch.as_tensor(pb.umask[0]).to(device)
    return rel, ok, g_u
