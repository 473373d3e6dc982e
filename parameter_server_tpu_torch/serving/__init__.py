"""Serving plane: the request-path frontend over live parameter tables.

Counterpart of ``parameter_server_tpu/serving/``: concurrent client
sessions issuing sparse pulls and predictions against a KVVector table
on the card, and LM decode against the transformer stack, with

- **admission control** (:mod:`.admission`): token-bucket rate limiting
  + queue-depth shedding with explicit 429-style rejection
  (:class:`RejectedError`);
- **request coalescing** (:mod:`.coalescer`): concurrent pulls merge
  into ONE executor submit over the union key set;
- **read replicas** (:mod:`.replica`): snapshot copies refreshed off the
  push path, held on the host or on the card;
- **continuous batching** (:mod:`.batcher`): concurrent decode sessions
  share one running speculative-decode state;
- **degraded-mode serving**: a failed or late live pull falls back to
  the replica inside a staleness bound; past it, the 503-style
  :class:`DegradedError`, distinct from the admission 429.

:mod:`.frontend` composes them into :class:`ServeFrontend`;
:mod:`.loadgen` is the open-loop Poisson load generator behind the serve
CLI (``apps/serve/main.py``).
"""

from .admission import AdmissionController, RejectedError, TokenBucket
from .batcher import BatcherConfig, ContinuousBatcher
from .coalescer import PullCoalescer
from .frontend import (
    DecodeRequest,
    DegradedError,
    PredictRequest,
    PullRequest,
    ServeConfig,
    ServeFrontend,
)
from .loadgen import LatencyStats, open_loop_bench
from .replica import ReadReplica

__all__ = [
    "AdmissionController",
    "BatcherConfig",
    "ContinuousBatcher",
    "DecodeRequest",
    "DegradedError",
    "LatencyStats",
    "PredictRequest",
    "PullCoalescer",
    "PullRequest",
    "ReadReplica",
    "RejectedError",
    "ServeConfig",
    "ServeFrontend",
    "TokenBucket",
    "open_loop_bench",
]
