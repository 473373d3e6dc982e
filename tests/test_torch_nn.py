"""PyTorch port: ConvNet / MLP, NNTrainer and the NN CLI against the JAX
package's.

Both sides run on the CPU; the JAX trainer sits on a 1x1 mesh. The
port's module starts from the flax parameters (``convert.
nn_params_from_flax``: HWIO -> OIHW, dense ``[in, out]`` -> ``[out,
in]``): ``jax.random`` and the port's ``torch.Generator`` init draw
different weights. The products are XLA's on one side and torch's
(oneDNN) on the other, which may sum in another order, and XLA contracts
the momentum update into fused multiply-adds: logits are held within
``LOGIT_TOL`` of their scale, losses and accuracies over training
steps within ``LOSS_RTOL``.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.apps.nn import main as jmain
from parameter_server_tpu.apps.nn.trainer import NNTrainer as JTrainer
from parameter_server_tpu.models import convnet as jconv
from parameter_server_tpu.parallel.mesh import make_mesh
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.nn import main as tmain
from parameter_server_tpu_torch.apps.nn.trainer import NNTrainer
from parameter_server_tpu_torch.models import convnet as tconv
from parameter_server_tpu_torch.parameter.replica import CheckpointManager
from parameter_server_tpu_torch.system.postoffice import Postoffice

torch.set_num_threads(1)

# logits: |port - JAX| within 1e-5 of max |logit| (another summation
# order in the convolutions and products)
LOGIT_TOL = 1e-5
# losses over a few SGD-momentum steps: the order of the sums and the
# FMA contraction compound step by step
LOSS_RTOL = 1e-4

MODELS = {
    "mlp": (lambda classes: (jconv.MLP(num_classes=classes), tconv.MLP(num_classes=classes)),
            (32,)),
    "convnet": (lambda classes: (jconv.ConvNet(num_classes=classes, width=8),
                                 tconv.ConvNet(num_classes=classes, width=8)), (16, 16, 3)),
}


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(num_data=1, num_server=1)


@pytest.fixture(autouse=True)
def hermetic():
    Postoffice.reset()
    JPostoffice.reset()
    yield
    Postoffice.reset()
    JPostoffice.reset()


def blobs(seed, n, shape, classes):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes,) + shape)
    y = rng.integers(0, classes, n)
    x = centers[y] + 0.5 * rng.normal(size=(n,) + shape)
    return x.astype(np.float32), y.astype(np.int32)


def flax_params(jmodel, shape, seed=0):
    return jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape))["params"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_flax(name):
    make, shape = MODELS[name]
    jm, tm = make(10)
    params = flax_params(jm, shape, seed=4)
    tm = tm.init(0, shape, "cpu")
    tm.load_state_dict(convert.nn_params_from_flax(params, "cpu"))
    x, y = blobs(1, 64, shape, 10)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (64, 10)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    loss_j = float(jconv.cross_entropy(jnp.asarray(want), jnp.asarray(y)))
    loss_t = float(tconv.cross_entropy(torch.from_numpy(np.array(want)), torch.from_numpy(y)))
    assert loss_t == pytest.approx(loss_j, rel=1e-6)
    back = convert.nn_params_to_flax(dict(tm.state_dict()))
    for layer, leaves in params.items():
        for leaf, arr in leaves.items():
            assert np.array_equal(back[layer][leaf], np.asarray(arr)), (layer, leaf)


def test_init_draws_lecun_normal_shapes():
    m = tconv.ConvNet(num_classes=10).init(0, (16, 16, 3), "cpu")
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == {"Conv_0.weight": (32, 3, 3, 3), "Conv_0.bias": (32,),
                      "Conv_1.weight": (64, 32, 3, 3), "Conv_1.bias": (64,),
                      "Dense_0.weight": (128, 1024), "Dense_0.bias": (128,),
                      "Dense_1.weight": (10, 128), "Dense_1.bias": (10,)}
    w = m.Dense_0.weight.detach()
    assert abs(float(w.std()) - (1 / 1024) ** 0.5) < 0.05 * (1 / 1024) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 1024) ** 0.5 / 0.87962566103423978 + 1e-7
    again = tconv.ConvNet(num_classes=10).init(0, (16, 16, 3), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trainer_losses_match_jax(mesh1, name):
    make, shape = MODELS[name]
    jm, tm = make(4)
    jt = JTrainer(jm, input_shape=shape, mesh=mesh1)
    tt = NNTrainer(tm, input_shape=shape, device="cpu")
    tt.model.load_state_dict(convert.nn_params_from_flax(jt.state_host()["params"], "cpu"))
    for step in range(3):
        x, y = blobs(10 + step, 32, shape, 4)
        mj, mt = jt.train_step(x, y), tt.train_step(x, y)
        assert mt["loss"] == pytest.approx(mj["loss"], rel=LOSS_RTOL), step
        assert mt["accuracy"] == mj["accuracy"], step
    x, y = blobs(99, 64, shape, 4)
    ej, et = jt.evaluate(x, y), tt.evaluate(x, y)
    assert et["loss"] == pytest.approx(ej["loss"], rel=LOSS_RTOL)
    assert et["accuracy"] == ej["accuracy"]
    back = convert.nn_params_from_flax(jt.state_host()["params"], "cpu")
    for key, p in tt.model.state_dict().items():
        scale = float(back[key].abs().max())
        assert float((p - back[key]).abs().max()) <= LOSS_RTOL * scale, key


def _cli_rows(module, po, argv):
    po.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue().splitlines()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cli_rows_match_the_jax_cli(monkeypatch, name):
    """The port's CLI against the JAX CLI on the same synthetic data, the
    port's model started from the flax init the JAX CLI draws (seed 0)."""
    argv = ["--model", name, "--steps", "6", "--report-every", "2", "--batch", "64"]
    want = _cli_rows(jmain, JPostoffice, argv)
    cls = {"mlp": tconv.MLP, "convnet": tconv.ConvNet}[name]
    jcls = {"mlp": jconv.MLP, "convnet": jconv.ConvNet}[name]
    init = cls.init

    def init_from_flax(self, seed, input_shape, device=None):
        init(self, seed, input_shape, device)
        params = flax_params(jcls(num_classes=self.num_classes), input_shape, seed)
        self.load_state_dict(convert.nn_params_from_flax(params, device))
        return self

    monkeypatch.setattr(cls, "init", init_from_flax)
    got = _cli_rows(tmain, Postoffice, argv + ["--device", "cpu"])
    assert got[0] == want[0] == f"{'step':>5} {'loss':>9} {'accuracy':>9}"
    assert len(got) == len(want) == 4
    for g, w in zip(got[1:], want[1:]):
        gs, ws = g.split(), w.split()
        assert gs[0] == ws[0]
        assert float(gs[1]) == pytest.approx(float(ws[1]), rel=LOSS_RTOL, abs=1e-5)
        assert gs[2] == ws[2]


def test_cli_defaults_learn_and_refuse_more_servers(monkeypatch):
    """The defaults learn; more servers are no longer refused: outside a
    world, ``--num-servers S --num-workers D`` starts ``D * S`` ranks
    (the spawn itself is recorded here; the worlds run in
    ``tests/test_torch_parallel_stores.py``)."""
    rows = _cli_rows(tmain, Postoffice, ["--steps", "20", "--device", "cpu"])
    losses = [float(r.split()[1]) for r in rows[1:]]
    assert len(losses) == 2 and losses[-1] < losses[0]
    seen = []
    monkeypatch.setattr(tmain, "_spawn", lambda argv, world, device: seen.append(
        (world, device, argv)) or 0)
    for extra in (["--num-servers", "2"], ["--num-servers", "2", "--num-workers", "2"]):
        assert _cli_rows(tmain, Postoffice, extra + ["--device", "cpu"]) == []
    assert [w for w, _, _ in seen] == [2, 4] and {d for _, d, _ in seen} == {"cpu"}
    assert seen[1][2] == ["--num-servers", "2", "--num-workers", "2", "--device", "cpu"]


def test_mlp_learns_blobs():
    x, y = blobs(0, 512, (16,), 4)
    trainer = NNTrainer(tconv.MLP(num_classes=4), input_shape=(16,), device="cpu")
    first = trainer.train_step(x, y)["loss"]
    for _ in range(29):
        m = trainer.train_step(x, y)
    assert trainer.evaluate(x, y)["accuracy"] > 0.9
    assert m["loss"] < first * 0.5


def test_convnet_step():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    trainer = NNTrainer(tconv.ConvNet(num_classes=10, width=8), input_shape=(16, 16, 3),
                        device="cpu")
    m1 = trainer.train_step(x, y)
    m2 = trainer.train_step(x, y)
    assert np.isfinite(m1["loss"]) and m2["loss"] <= m1["loss"] * 1.5


def test_checkpoint_restore_roundtrip(tmp_path):
    """A fresh trainer (another seed) restores the parameters, the momentum
    and the step count, and trains on in step with the original."""
    x, y = blobs(0, 256, (16,), 4)
    t1 = NNTrainer(tconv.MLP(num_classes=4), input_shape=(16,), device="cpu")
    for _ in range(10):
        t1.train_step(x, y)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    t1.checkpoint(mgr, step=10)
    want = t1.evaluate(x, y)
    t2 = NNTrainer(tconv.MLP(num_classes=4), input_shape=(16,), device="cpu", seed=99)
    assert t2.restore(mgr) == 10 and t2.steps_done == 10
    assert t2.evaluate(x, y) == want
    assert t1.train_step(x, y) == t2.train_step(x, y)


def test_params_live_in_kv_layer():
    trainer = NNTrainer(tconv.MLP(num_classes=2), input_shape=(8,), device="cpu")
    assert len(trainer.kv.layers) == 4  # 2 dense layers x (weight, bias)
    snap = trainer.kv.get_replica()
    assert all(isinstance(v, np.ndarray) for v in snap.values())
    # a KVLayer push (its SGD updater, in place) moves the model's weights
    before = trainer.model.Dense_1.bias.detach().clone()
    trainer.push("Dense_1.bias", torch.ones(2))
    assert torch.equal(trainer.pull("Dense_1.bias"), before - 0.01)
    assert torch.equal(trainer.model.Dense_1.bias.detach(), before - 0.01)
    got = trainer.push_pull("Dense_1.bias", torch.ones(2))
    assert torch.equal(got, trainer.model.Dense_1.bias.detach())
