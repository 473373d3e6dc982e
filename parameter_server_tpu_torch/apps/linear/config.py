"""Linear-method configuration (the fields the port reads).

Dataclass counterparts of ``parameter_server_tpu/apps/linear/config.py``
with the same field names and defaults. Fields of features the port
does not have yet are kept so that setting them fails loudly:
:meth:`SGDConfig.validate` raises ``NotImplementedError`` for any value
other than the default, and unknown loss, penalty, learning-rate or
update names raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class LossConfig:
    type: str = "logit"  # logit | square | square_hinge


@dataclasses.dataclass
class PenaltyConfig:
    type: str = "l1"  # l1 | l2
    lambda_: List[float] = dataclasses.field(default_factory=lambda: [0.1])


@dataclasses.dataclass
class LearningRateConfig:
    type: str = "decay"  # constant | decay
    alpha: float = 0.1
    beta: float = 1.0


# field -> the only value the port supports, for features not ported yet
_UNPORTED = {
    "max_delay": 0,  # bounded delay and the threaded executor
    "push_filter": [],  # FIXING_FLOAT / ADD_NOISE filters
    "pull_filter": [],
    "ell_lanes": 0,  # ELL / bits / stream wires
    "wire": "",
    "wire_encode": "",  # compact exact wire
    "wire_compress": "",
    "wire_cache_mb": 0,
    "num_replicas": 0,  # server replicas
    "tau_adaptive": False,  # adaptive tau
    "kkt_filter": False,  # KKT significance filter
}


@dataclasses.dataclass
class SGDConfig:
    """Counterpart of the JAX package's SGDConfig (async_sgd section)."""

    algo: str = "ftrl"  # ftrl | standard
    minibatch: int = 1000
    ada_grad: bool = True  # for algo=standard
    num_slots: int = 1 << 22  # hashed weight table size
    rows_pad: int = 0  # 0 = minibatch size
    nnz_pad: int = 0  # 0 = auto from first batch
    steps_per_launch: int = 1  # T minibatches per submission
    ftrl_state_dtype: str = "float32"  # float32 | bfloat16 (sqrt_n only)
    update: str = "auto"  # auto | dense | sparse
    max_delay: int = 0
    push_filter: list = dataclasses.field(default_factory=list)
    pull_filter: list = dataclasses.field(default_factory=list)
    ell_lanes: int = 0
    wire: str = ""
    wire_encode: str = ""
    wire_compress: str = ""
    wire_cache_mb: int = 0
    num_replicas: int = 0
    tau_adaptive: bool = False
    kkt_filter: bool = False

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for name, supported in _UNPORTED.items():
            if getattr(self, name) != supported:
                raise NotImplementedError(
                    f"SGDConfig.{name}={getattr(self, name)!r} is not "
                    f"ported to the PyTorch package yet (only "
                    f"{supported!r} is supported)"
                )
        if self.algo not in ("ftrl", "standard"):
            raise ValueError(f"unknown sgd algo: {self.algo}")
        if self.ftrl_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "ftrl_state_dtype must be 'float32' or 'bfloat16', got "
                f"{self.ftrl_state_dtype!r}"
            )
        if self.update not in ("auto", "dense", "sparse"):
            raise ValueError(
                f"unknown SGDConfig.update {self.update!r}; expected "
                "'auto', 'dense', or 'sparse'"
            )


@dataclasses.dataclass
class Config:
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    penalty: PenaltyConfig = dataclasses.field(default_factory=PenaltyConfig)
    learning_rate: LearningRateConfig = dataclasses.field(
        default_factory=LearningRateConfig
    )
    async_sgd: SGDConfig = dataclasses.field(default_factory=SGDConfig)
