"""PyTorch port: the KKT significance mask against the JAX package's.

``ops/significance.py::kkt_mask`` on the same seeded unique-slot
vectors (z, g, w, umask) as ``parameter_server_tpu/ops/significance.py``:
the keep mask and the suppressed count are bit-equal for escape 0, 1/64
and 1, margins below and above 1, and an all-suppressed case. The
escape stream is keyed by position in the padded unique vector, so
``test_unique_padding_matches_jax`` pins the port's padding rule to the
JAX worker's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.ops import significance as jsig
from parameter_server_tpu_torch.ops import significance as tsig

U, LIVE = 4096, 3000


def _inputs(seed, at_zero=0.6, l1=1.0):
    rng = np.random.default_rng(seed)
    umask = (np.arange(U) < LIVE).astype(np.float32)
    w = np.where(rng.random(U) < at_zero, 0.0, rng.normal(size=U)).astype(np.float32) * umask
    z = (rng.normal(size=U) * l1).astype(np.float32) * umask
    g = (rng.normal(size=U) * 0.5).astype(np.float32) * umask
    return z, g, w, umask


CASES = [
    dict(escape=0.0, margin=1.0),
    dict(escape=1.0 / 64.0, margin=1.0),
    dict(escape=1.0 / 64.0, margin=0.5),
    dict(escape=0.25, margin=2.0),
    dict(escape=1.0, margin=1.0),
    dict(escape=0.0, margin=1e9),  # every slot at zero is suppressed
]


@pytest.mark.parametrize("case", CASES, ids=[f"escape{c['escape']:g}-margin{c['margin']:g}"
                                             for c in CASES])
@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_kkt_mask_matches_jax(case, seed):
    z, g, w, umask = _inputs(seed & 0xFFFF)
    jspec = jsig.SignificanceSpec(l1=1.0, **case)
    tspec = tsig.SignificanceSpec(l1=1.0, **case)
    jkeep, jsup = jsig.kkt_mask(jnp.asarray(z), jnp.asarray(g), jnp.asarray(w),
                                jnp.asarray(umask), seed, spec=jspec)
    tkeep, tsup = tsig.kkt_mask(*(torch.from_numpy(a) for a in (z, g, w, umask)), seed,
                                spec=tspec)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert float(tsup) == float(jsup)
    assert tkeep[LIVE:].all()  # padding keeps
    if case["escape"] >= 1.0:
        assert float(tsup) == 0.0 and tkeep.all()
    elif case["margin"] > 1e6 and case["escape"] == 0.0:
        assert float(tsup) == float(((w == 0) & (umask > 0)).sum())
    else:
        assert 0 < float(tsup) < LIVE


def test_escape_share_is_as_configured():
    z, g, w, umask = _inputs(3)
    base = tsig.kkt_mask(*(torch.from_numpy(a) for a in (z, g, w, umask)), 11,
                         spec=tsig.SignificanceSpec(l1=1.0, margin=1e9, escape=0.0))[1]
    esc = tsig.kkt_mask(*(torch.from_numpy(a) for a in (z, g, w, umask)), 11,
                        spec=tsig.SignificanceSpec(l1=1.0, margin=1e9, escape=0.25))[1]
    assert 0.65 < float(esc) / float(base) < 0.85


def test_spec_fields_and_feedback_match_jax():
    j = jsig.SignificanceSpec(l1=0.5, feedback=True)
    t = tsig.SignificanceSpec(l1=0.5, feedback=True)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.without_feedback()) == dataclasses.asdict(j.without_feedback())
    assert not t.without_feedback().feedback


@pytest.mark.parametrize("nnz_pad,slots", [(4096, 1 << 12), (53248, 1 << 22), (651264, 1 << 30),
                                           (1 << 20, 1 << 16)])
def test_unique_padding_matches_jax(nnz_pad, slots):
    """The unique width both workers pad to on one card: the JAX rule is
    ``min(nnz_pad * shards, num_slots)`` rounded up to 1024, the port's
    ``min(nnz_pad, num_slots)`` likewise; the escape decisions depend on
    it."""
    from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
    from parameter_server_tpu_torch.apps.linear.config import Config, SGDConfig
    from parameter_server_tpu_torch.utils.sparse import random_sparse

    c = Config()
    c.async_sgd = SGDConfig(num_slots=slots, minibatch=64, nnz_pad=nnz_pad, update="sparse")
    w = tsgd.AsyncSGDWorker.__new__(tsgd.AsyncSGDWorker)
    w.sgd, w.num_slots, w._update_mode, w._pads, w._consistency = c.async_sgd, slots, "sparse", None, None
    w.directory = tsgd.KeyDirectory(slots)
    w._wire = {}
    got = w.prep(random_sparse(64, 1 << 14, 8, seed=0, binary=True), device_put=False)
    jax_rule = -(-min(nnz_pad * 1, slots) // 1024) * 1024
    assert got.uslots.shape[-1] == jax_rule
