"""Linear-method configuration and the reference's ``.conf`` parser.

Dataclass counterparts of ``parameter_server_tpu/apps/linear/config.py``
with the same field names and defaults, and :func:`parse_conf` for the
reference's protobuf-text ``.conf`` files (an ``async_sgd`` block, a
``darlin`` block, or neither for model evaluation). Fields of features
the port does not have yet (server replicas) are kept so that setting
them fails loudly: :meth:`SGDConfig.validate` raises
``NotImplementedError`` for any value other than the default. Unknown
loss, penalty, learning-rate, update or pull-gather names raise
``ValueError``. As in the JAX parser, a ``darlin`` block's
``tail_feature_freq`` is not read, and ``save_model_every_n_iter`` is
read and used by nothing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional


@dataclasses.dataclass
class DataConfig:
    """A data source or sink of a conf (``training_data``,
    ``validation_data``, ``model_output``, ``model_input``)."""

    format: str = "text"  # text | record | bin
    text: str = "libsvm"  # libsvm | criteo | ps_sparse_binary | ...
    file: List[str] = dataclasses.field(default_factory=list)
    ignore_feature_group: bool = False


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
    "num_replicas": 0,  # server replicas (ROADMAP A13)
    "replica_every": 1,
}


@dataclasses.dataclass
class SGDConfig:
    """Counterpart of the JAX package's SGDConfig (async_sgd section)."""

    algo: str = "ftrl"  # ftrl | standard
    minibatch: int = 1000
    data_buf: int = 1000  # prefetch budget, MB
    ada_grad: bool = True  # for algo=standard
    max_delay: int = 0  # bounded-delay window τ, in ministeps
    num_data_pass: int = 1
    report_interval: float = 1.0
    tail_feature_freq: int = 0  # count-min tail filter threshold; 0 = off
    countmin_n: int = 100_000_000
    countmin_k: int = 2
    push_filter: list = dataclasses.field(default_factory=list)
    pull_filter: list = dataclasses.field(default_factory=list)
    pull_gather: str = "auto"  # auto (= wide) | wide | narrow
    num_slots: int = 1 << 22  # hashed weight table size
    rows_pad: int = 0  # 0 = minibatch size
    nnz_pad: int = 0  # 0 = auto from first batch
    steps_per_launch: int = 1  # T minibatches per submission
    # prep-pool width of the pipelined train: 0 = the host's cores less
    # one, at most 4; the trajectory is the same at any width
    ingest_workers: int = 0
    ftrl_state_dtype: str = "float32"  # float32 | bfloat16 (sqrt_n only)
    update: str = "auto"  # auto | dense | sparse
    ell_lanes: int = 0
    wire_u24: bool = False
    wire: str = ""
    wire_encode: str = ""
    wire_compress: str = ""
    wire_cache_mb: int = 0
    num_replicas: int = 0
    replica_every: int = 1
    # adaptive bounded delay (learner/consistency.py): max_delay is the
    # cap, the live tau moves in [0, max_delay]
    tau_adaptive: bool = False
    # KKT significance filter (ops/significance.py), sparse update only
    kkt_filter: bool = False
    kkt_margin: float = 1.0
    kkt_escape: float = 1.0 / 64.0
    # host-side drop of slots suppressed this many collects in a row
    # (0 = off; needs ingest_workers=1), revisited every n-th batch
    kkt_drop_after: int = 0
    kkt_revisit_every: int = 64

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
        if self.pull_gather not in ("auto", "narrow", "wide"):
            raise ValueError(
                f"unknown SGDConfig.pull_gather {self.pull_gather!r}; "
                "expected 'auto', 'narrow', or 'wide'"
            )


@dataclasses.dataclass
class BCDConfig:
    """Counterpart of the JAX package's BCDConfig (the ``darlin`` block:
    the reference's bcd.proto and linear.proto's darlin fields)."""

    num_data_pass: int = 10  # max_pass_of_data
    feature_block_ratio: float = 4.0
    random_feature_block_order: bool = True
    max_block_delay: int = 0
    epsilon: float = 1e-4
    save_model_every_n_iter: int = 0
    load_local_data: bool = False
    comm_filter: list = dataclasses.field(default_factory=list)
    # the trust region of the shrink step
    delta_init_value: float = 1.0
    delta_max_value: float = 5.0
    kkt_filter_threshold_ratio: float = 10.0


@dataclasses.dataclass
class Config:
    training_data: DataConfig = dataclasses.field(default_factory=DataConfig)
    validation_data: Optional[DataConfig] = None
    model_output: Optional[DataConfig] = None
    model_input: Optional[DataConfig] = None
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    penalty: PenaltyConfig = dataclasses.field(default_factory=PenaltyConfig)
    learning_rate: LearningRateConfig = dataclasses.field(
        default_factory=LearningRateConfig
    )
    async_sgd: Optional[SGDConfig] = None
    darlin: Optional[BCDConfig] = None


_ENUMS = {
    "LOGIT": "logit", "SQUARE": "square", "HINGE": "hinge",
    "SQUARE_HINGE": "square_hinge", "L1": "l1", "L2": "l2",
    "CONSTANT": "constant", "DECAY": "decay", "FTRL": "ftrl",
    "STANDARD": "standard", "TEXT": "text", "LIBSVM": "libsvm",
    "CRITEO": "criteo", "ADFEA": "adfea", "TERAFEA": "terafea",
    # PROTO is the reference's protobuf Example recordio format
    "BIN": "bin", "PROTO": "ref_record",
    "SPARSE": "ps_sparse", "SPARSE_BINARY": "ps_sparse_binary",
    "DENSE": "ps_dense", "KEY_CACHING": "key_caching",
    "COMPRESSING": "compressing", "FIXING_FLOAT": "fixing_float",
}


def _ftrl_state_dtype(val) -> str:
    """Validated ftrl_state_dtype, at parse time."""
    v = str(val).lower()
    if v not in ("float32", "bfloat16"):
        raise ValueError(
            f"ftrl_state_dtype must be 'float32' or 'bfloat16', got {val!r}"
        )
    return v


def parse_conf_dict(text: str) -> dict:
    """Parse protobuf text format into nested dicts (repeated -> lists)."""
    text = re.sub(r"#[^\n]*", "", text)

    def parse_block(pos: int):
        out: dict = {}
        while pos < len(text):
            while pos < len(text) and text[pos] in " \t\r\n;":
                pos += 1
            if pos >= len(text) or text[pos] == "}":
                return out, pos + 1
            m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)\s*", text[pos:])
            if not m:
                raise ValueError(f"parse error at {text[pos:pos+40]!r}")
            key = m.group(1)
            pos += m.end()
            if pos < len(text) and text[pos] == "{":
                val, pos = parse_block(pos + 1)
            else:
                if text[pos] == ":":
                    pos += 1
                while pos < len(text) and text[pos] in " \t":
                    pos += 1
                if text[pos] == "{":
                    val, pos = parse_block(pos + 1)
                elif text[pos] == '"':
                    end = text.index('"', pos + 1)
                    val = text[pos + 1 : end]
                    pos = end + 1
                else:
                    m2 = re.match(r"[^\s{}]+", text[pos:])
                    raw = m2.group(0)
                    pos += m2.end()
                    val = _coerce(raw)
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(val)
            else:
                out[key] = val
        return out, pos

    d, _ = parse_block(0)
    return d


def _coerce(raw: str):
    if raw in _ENUMS:
        return _ENUMS[raw]
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        return raw


def _filter_list(v) -> list:
    """Normalize repeated ``push_filter { ... }`` blocks to a list of dicts."""
    if v is None:
        return []
    return list(v) if isinstance(v, list) else [v]


def _data_config(d: dict) -> DataConfig:
    files = d.get("file", [])
    if not isinstance(files, list):
        files = [files]
    return DataConfig(
        format=str(d.get("format", "text")).lower(),
        text=str(d.get("text", "libsvm")).lower(),
        file=[str(f) for f in files],
        ignore_feature_group=bool(d.get("ignore_feature_group", False)),
    )


def parse_conf(text: str) -> Config:
    """Parse a reference-style .conf (protobuf text) into Config."""
    d = parse_conf_dict(text)
    cfg = Config()
    if "training_data" in d:
        cfg.training_data = _data_config(d["training_data"])
    if "validation_data" in d:
        cfg.validation_data = _data_config(d["validation_data"])
    if "model_output" in d:
        cfg.model_output = _data_config(d["model_output"])
    if "model_input" in d:
        cfg.model_input = _data_config(d["model_input"])
    if "loss" in d:
        cfg.loss = LossConfig(type=str(d["loss"].get("type", "logit")))
    if "penalty" in d:
        lam = d["penalty"].get("lambda", [0.1])
        if not isinstance(lam, list):
            lam = [lam]
        cfg.penalty = PenaltyConfig(
            type=str(d["penalty"].get("type", "l1")), lambda_=[float(x) for x in lam]
        )
    if "learning_rate" in d:
        lr = d["learning_rate"]
        cfg.learning_rate = LearningRateConfig(
            type=str(lr.get("type", "decay")),
            alpha=float(lr.get("alpha", 0.1)),
            beta=float(lr.get("beta", 1.0)),
        )
    if "async_sgd" in d:
        s = d["async_sgd"]
        cfg.async_sgd = SGDConfig(
            algo=str(s.get("algo", "ftrl")),
            minibatch=int(s.get("minibatch", 1000)),
            data_buf=int(s.get("data_buf", 1000)),
            ada_grad=bool(s.get("ada_grad", True)),
            max_delay=int(s.get("max_delay", 0)),
            num_data_pass=int(s.get("num_data_pass", 1)),
            report_interval=float(s.get("report_interval", 1.0)),
            tail_feature_freq=int(s.get("tail_feature_freq", 0)),
            countmin_n=int(float(s.get("countmin_n", 1e8))),
            countmin_k=int(s.get("countmin_k", 2)),
            num_slots=int(s.get("num_slots", 1 << 22)),
            rows_pad=int(s.get("rows_pad", 0)),
            nnz_pad=int(s.get("nnz_pad", 0)),
            ell_lanes=int(s.get("ell_lanes", 0)),
            wire_u24=bool(s.get("wire_u24", False)),
            wire=str(s.get("wire", "")),
            num_replicas=int(s.get("num_replicas", 0)),
            replica_every=int(s.get("replica_every", 1)),
            steps_per_launch=int(s.get("steps_per_launch", 1)),
            ftrl_state_dtype=_ftrl_state_dtype(
                s.get("ftrl_state_dtype", "float32")
            ),
            push_filter=_filter_list(s.get("push_filter")),
            pull_filter=_filter_list(s.get("pull_filter")),
            pull_gather=str(s.get("pull_gather", "auto")),
        )
    if "darlin" in d:
        b = d["darlin"]
        cfg.darlin = BCDConfig(
            num_data_pass=int(b.get("max_pass_of_data", b.get("num_data_pass", 10))),
            feature_block_ratio=float(b.get("feature_block_ratio", 4.0)),
            random_feature_block_order=bool(b.get("random_feature_block_order", True)),
            max_block_delay=int(b.get("max_block_delay", 0)),
            epsilon=float(b.get("epsilon", 1e-4)),
            save_model_every_n_iter=int(b.get("save_model_every_n_iter", 0)),
            load_local_data=bool(b.get("load_local_data", False)),
            delta_init_value=float(b.get("delta_init_value", 1.0)),
            delta_max_value=float(b.get("delta_max_value", 5.0)),
            kkt_filter_threshold_ratio=float(b.get("kkt_filter_threshold_ratio", 10.0)),
            comm_filter=_filter_list(b.get("comm_filter")),
        )
    return cfg
