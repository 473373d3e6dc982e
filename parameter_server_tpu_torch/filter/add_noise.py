"""Gaussian noise on the wire (the reference's ``src/filter/add_noise.h``).

Copy of ``parameter_server_tpu/filter/add_noise.py``: encode adds
N(mean, std) noise, drawn from the filter's own ``default_rng(0)``, to
each float value array; decode leaves the noise in. The device wire's
ADD_NOISE perturbation is the step's own (``apps/linear/async_sgd.py``).
"""

from __future__ import annotations

import numpy as np

from ..system.message import FilterSpec, Message
from .base import Filter, register


@register
class AddNoiseFilter(Filter):
    TYPE = "add_noise"

    def __init__(self) -> None:
        self._rng = np.random.default_rng(0)

    def encode(self, msg: Message, spec: FilterSpec) -> Message:
        if spec.std <= 0:
            return msg
        msg.values = [
            (v + self._rng.normal(spec.mean, spec.std, v.shape).astype(v.dtype))
            if v.dtype.kind == "f"
            else v
            for v in msg.values
        ]
        return msg
