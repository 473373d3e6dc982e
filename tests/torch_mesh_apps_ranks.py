"""Rank functions of the port's mesh tests of the ELL wires, the
resharded checkpoint and the A10 stores (FM, wide&deep, ``KVMap``,
``KVLayer``, ``NNTrainer``): each runs in every process of a gloo world
of CPU ranks that ``parallel.launch.run_world`` starts, and returns
plain numpy results for the test process to hold against the JAX
package. Imports the port only (no JAX: the ranks never load it).
"""

import numpy as np
import torch

from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parameter.replica import CheckpointManager
from tests import torch_parallel_ranks as ranks


def ell_conf(wire, lanes, steps, push_bytes=0, dtype="float32", num_slots=ranks.SLOTS):
    """The mesh linear tests' conf on an ELL wire (dense update)."""
    c = ranks.linear_conf("dense", dtype, steps, push_bytes)
    c.async_sgd.ell_lanes, c.async_sgd.wire = lanes, wire
    c.async_sgd.num_slots = num_slots
    return c


def ell_cases(cases, batch_sets, probe_keys):
    """Every case ``(num_data, num_server, wire, lanes, steps,
    push_bytes)`` on a mesh of that shape (a prefix of the world; the
    other ranks idle), trained on ``batch_sets[wire]``. Per case: this
    rank's coordinates, the prepped wire's type, server shard of the
    state, per-launch metrics, the whole weights and the pulled weights
    of ``probe_keys``; None on an idle rank."""
    results = []
    for d, s, wire, lanes, steps, push in cases:
        mesh = meshlib.make_mesh(d, s, device="cpu")
        if not mesh.active:
            results.append(None)
            continue
        worker = tsgd.AsyncSGDWorker(ell_conf(wire, lanes, steps, push), mesh=mesh)
        batches = batch_sets[wire]
        try:
            kind = type(worker.prep(batches[0], device_put=False)).__name__
            metrics = ranks.train_linear(worker, batches, steps)
            shard = worker.state_host()["state"]
            whole = worker.weights_dense()
            pulled = worker.pull(probe_keys)
        finally:
            worker.remove()
        results.append({"coords": mesh.coords, "kind": kind, "state": shard,
                        "metrics": metrics, "weights": whole, "pulled": pulled})
    return results


def reshard_checkpoint(directory, conf, first, replay):
    """``tests/test_reshard.py``'s drill over the world of 8: a 4 x 2
    mesh trains ``first``, checkpoints (the whole state, step 5), trains
    ``replay``; a 2 x 4 mesh of the same ranks restores step 5 and
    trains ``replay`` again. Returns both meshes' whole weights after
    the replay."""
    mgr = CheckpointManager(directory)
    out = {}
    for name, (d, s) in (("a", (4, 2)), ("b", (2, 4))):
        mesh = meshlib.make_mesh(d, s, device="cpu")
        worker = tsgd.AsyncSGDWorker(conf, mesh=mesh)
        try:
            if name == "a":
                worker.train(iter(first))
                worker.checkpoint(mgr, step=5)
            else:
                out["restored_step"] = worker.restore(mgr)
            worker.train(iter(replay))
            out[name] = worker.weights_dense()
        finally:
            worker.remove()
    return out


# -- the A10 stores and the embedding workers at 2 x 2 --


def _progress(p):
    """A batch's ``SGDProgress``: its example count, objective, accuracy, AUC."""
    return (int(p.num_examples_processed), float(p.objective[-1]), float(p.accuracy[-1]),
            float(p.auc[-1]))


def embedding_worker(cls_name, conf, kw, whole, train, final, eval_batch):
    """``FMWorker`` or ``DeepCTRWorker`` on a 2 x 2 mesh: started from the
    JAX worker's initial whole state (this rank's shard of it), trained
    on ``train``; then, loaded with the JAX worker's ``final`` whole
    state, its ``predict_margin`` and ``evaluate`` on ``eval_batch``;
    then shard 1 wiped and a recovery asked for. Returns this rank's
    coordinates, shard of the trained state, progress after each batch,
    margins, evaluation, and the table after the wipe."""
    from parameter_server_tpu_torch import convert
    from parameter_server_tpu_torch.apps.linear import deep_ctr, fm

    cls = {"fm": fm.FMWorker, "deep": deep_ctr.DeepCTRWorker}[cls_name]
    mesh = meshlib.make_mesh(2, 2, device="cpu")
    s = mesh.server_index

    def shard(tree):
        return convert.tree_to_numpy(convert.shard_state(tree, 2, s, "cpu"))

    w = cls(conf, mesh=mesh, **kw)
    try:
        fresh = w.state_host()["state"]
        w.load_state_host({"state": shard(whole)})
        progress = [_progress(w.collect(w.process_minibatch(b))) for b in train]
        trained = w.state_host()["state"]
        w.load_state_host({"state": shard(final)})
        margins = w.predict_margin(eval_batch)
        ev = w.evaluate(eval_batch)
        w.wipe_server_shard(1)
        recovered = w.recover_server_shard(1)
        wiped = w.state_host()["state"]
    finally:
        w.executor.stop()
    return {"coords": mesh.coords, "fresh": fresh, "trained": trained, "progress": progress,
            "margins": margins, "evaluate": ev, "recovered": recovered, "wiped": wiped}


def kv_stores(map_cases, layer_case):
    """``KVMap`` (each case ``(entry, k, num_slots, keys, pushes, probe)``:
    pushes applied in order, the whole table, the probe's values and
    the written file) and ``KVLayer`` (``(partition_thr, lr, shapes,
    grads)``: each layer's placement, every push's pull, one push_pull,
    the replica, and a replica round trip) on a 2 x 2 mesh."""
    import os
    import tempfile

    from parameter_server_tpu_torch.parameter import kv_layer, kv_map

    mesh = meshlib.make_mesh(2, 2, device="cpu")
    out = {"coords": mesh.coords, "maps": []}
    for entry, k, num_slots, keys, pushes, probe in map_cases:
        e = {"assign": kv_map.AssignEntry, "add": kv_map.AddEntry}[entry]()
        m = kv_map.KVMap(e, k=k, num_slots=num_slots, keys=keys, mesh=mesh, name="m")
        try:
            for pk, pv in pushes:
                m.wait(m.push(m.request(), pk, pv))
            rec = {"rows": m.state["value"].shape[0], "table": m.get_replica()["value"],
                   "values": m.values(probe)}
            path = os.path.join(tempfile.mkdtemp(prefix="kvmap_"), "out.txt")
            m.write_to_file(path)
            rec["file"] = open(path).read() if os.path.exists(path) else None
            back = kv_map.KVMap(type(e)(), k=k, num_slots=num_slots, keys=keys, mesh=mesh,
                                name="m2")
            back.set_replica(m.get_replica())
            rec["round_trip"] = back.values(probe)
            back.executor.stop()
        finally:
            m.executor.stop()
        out["maps"].append(rec)
    thr, lr, shapes, grads = layer_case
    layer = kv_layer.KVLayer(partition_thr=thr, updater=kv_layer.SGDUpdater(lr=lr), mesh=mesh)
    try:
        rec = {"dims": {}, "blocks": {}, "pulls": {}}
        for key, shape in shapes.items():
            layer.init_layer(key, shape)
            rec["dims"][key] = layer.sharded_dim(shape)
        for key, g in grads:
            layer.wait(layer.push(layer.request(), key, g))
            rec["pulls"].setdefault(key, []).append(
                layer.wait_pull(layer.pull(layer.request(), key)).numpy().copy())
        key, g = grads[0]
        rec["push_pull"] = layer.wait_pull(layer.push_pull(layer.request(), key, g)).numpy()
        rec["blocks"] = {key: tuple(layer.layer(key).shape) for key in shapes}
        rec["replica"] = layer.get_replica()
        layer.set_replica({key: v * 2 for key, v in rec["replica"].items()})
        rec["set_back"] = layer.get_replica()
    finally:
        layer.executor.stop()
    out["layer"] = rec
    return out


def nn_trainers(cases, steps_batches, probe):
    """``NNTrainer`` on a 2 x 2 mesh, each case ``(name, classes, shape,
    flax-converted params)``: the port module loaded with the params,
    ``steps_batches`` trained (the losses and accuracies), evaluated on
    ``probe``; the KVLayer's layer count, its replica, and a
    checkpoint round trip (state_host into a trainer of another seed,
    the next step's loss)."""
    from parameter_server_tpu_torch.apps.nn.trainer import NNTrainer
    from parameter_server_tpu_torch.models import convnet

    mesh = meshlib.make_mesh(2, 2, device="cpu")
    out = []
    for name, classes, shape, params in cases:
        make = {"mlp": lambda: convnet.MLP(num_classes=classes),
                "convnet": lambda: convnet.ConvNet(num_classes=classes, width=8)}[name]
        t = NNTrainer(make(), input_shape=shape, mesh=mesh)
        t.model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
        metrics = [t.train_step(x, y) for x, y in steps_batches[name]]
        ev = t.evaluate(*probe[name])
        params = {k: p.detach().numpy().copy() for k, p in t.model.state_dict().items()}
        replica = t.kv.get_replica()
        snap = t.state_host()
        other = NNTrainer(make(), input_shape=shape, mesh=mesh, seed=99)
        other.load_state_host(snap)
        x, y = steps_batches[name][0]
        nxt = (t.train_step(x, y)["loss"], other.train_step(x, y)["loss"])
        out.append({"metrics": metrics, "evaluate": ev, "n_layers": len(t.kv.layers),
                    "replica": replica, "params": params, "next": nxt})
        t.kv.executor.stop()
        other.kv.executor.stop()
    return {"coords": mesh.coords, "cases": out}


def stores_world(fm_args, deep_args, kv_args, nn_args):
    """Every 2 x 2 case of ``tests/test_torch_parallel_stores.py`` in one
    world: the FM and wide&deep workers, the stores, the NN trainers."""
    return {"fm": embedding_worker("fm", *fm_args), "deep": embedding_worker("deep", *deep_args),
            "kv": kv_stores(*kv_args), "nn": nn_trainers(*nn_args)}
