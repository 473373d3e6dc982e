"""Rank functions of the port's mesh tests: each runs in every process
of a gloo world of CPU ranks that ``parallel.launch.run_world`` starts,
and returns plain numpy results for the test process to hold against the
JAX package. Imports the port only (no JAX: the ranks never load it).
"""

import numpy as np
import torch

from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.apps.linear import async_sgd as tsgd
from parameter_server_tpu_torch.apps.linear import config as tcfg
from parameter_server_tpu_torch.ops import kv_ops
from parameter_server_tpu_torch.parallel import distributed
from parameter_server_tpu_torch.parallel import mesh as meshlib
from parameter_server_tpu_torch.parameter.kv_vector import KVVector

MB, SLOTS = 256, 1 << 12


def linear_conf(update, dtype, steps, push_bytes=0):
    """The linear step tests' conf (``tests/test_torch_linear_step.py``)."""
    c = tcfg.Config()
    c.penalty = tcfg.PenaltyConfig(type="l1", lambda_=[1.0])
    c.learning_rate = tcfg.LearningRateConfig(type="decay", alpha=0.1, beta=1.0)
    c.async_sgd = tcfg.SGDConfig(
        algo="ftrl", minibatch=MB, num_slots=SLOTS, max_delay=0,
        update=update, ftrl_state_dtype=dtype, steps_per_launch=steps,
    )
    if push_bytes:
        c.async_sgd.push_filter = [{"type": "fixing_float", "num_bytes": push_bytes}]
    return c


def train_linear(worker, batches, steps):
    """Launches of ``steps`` minibatches (a superbatch when > 1); each
    launch's metrics as numpy."""
    out = []
    for lo in range(0, len(batches), steps):
        group = batches[lo:lo + steps]
        if steps > 1:
            m = worker.submit_superbatch(group, with_aux=True)
        else:
            m = worker.wait(worker.process_minibatch(group[0]))
        out.append({k: v.numpy().copy() for k, v in m.items()})
    return out


def linear_cases(cases, batches, probe_keys, resume=None):
    """Every case ``(num_data, num_server, update, dtype, steps,
    push_bytes)`` on a mesh of that shape (a prefix of the world; the
    other ranks idle). Per case: this rank's coordinates, server shard
    of the state, per-launch metrics, the whole weights and the pulled
    weights of ``probe_keys``; None on an idle rank. ``resume``: ``(case,
    whole state, seed counter, batches)``, a case started from the JAX
    mesh worker's whole state (``convert.shard_state`` cuts this rank's
    shard) and trained on ``batches``, appended last."""
    results = []
    todo = [(case, batches, None) for case in cases]
    if resume is not None:
        case, whole, counter, more = resume
        todo.append((case, more, (whole, counter)))
    for (d, s, update, dtype, steps, push), group, start in todo:
        mesh = meshlib.make_mesh(d, s, device="cpu")
        if not mesh.active:
            results.append(None)
            continue
        worker = tsgd.AsyncSGDWorker(linear_conf(update, dtype, steps, push), mesh=mesh)
        if start is not None:
            shard = convert.shard_state(start[0], s, mesh.server_index, "cpu")
            worker.load_state_host({"state": convert.state_to_numpy(shard),
                                    "seed_counter": start[1]})
        try:
            metrics = train_linear(worker, group, steps)
            shard = worker.state_host()["state"]
            whole = worker.weights_dense()
            pulled = worker.pull(probe_keys)
        finally:
            worker.remove()
        results.append({"coords": mesh.coords, "state": shard, "metrics": metrics,
                        "weights": whole, "pulled": pulled})
    return results


def kv_cases(layouts, table, idx, vals, kv_keys, kv_vals):
    """The kv_ops and KVVector parity cases on meshes ``layouts``
    (``(num_data, num_server)``): ``table`` [P, k] whole (each rank takes
    its server shard), ``idx`` [D_max, n] and ``vals`` [D_max, n, k] one
    row a data rank. Per layout: localize, pull (batch-sharded and
    replicated), push / push_pull in each combine mode, and a KVVector
    pushed ``kv_keys``/``kv_vals`` then pulled; and the data-row and
    layout helpers (``distributed``, ``partition``, ``init_sharded``). An
    idle rank reports whether ``local_data_shards`` refuses it."""
    out = []
    for d_n, s_n in layouts:
        mesh = meshlib.make_mesh(d_n, s_n, device="cpu")
        if not mesh.active:
            try:
                distributed.local_data_shards(mesh)
                out.append({"idle": "not refused"})
            except ValueError as e:
                out.append({"idle": str(e)})
            continue
        d, s = mesh.coords
        rows = table.shape[0] // s_n
        shard = torch.from_numpy(table[s * rows:(s + 1) * rows].copy())
        ix = torch.from_numpy(idx[d])
        v = torch.from_numpy(vals[d])
        rel, ok = kv_ops.localize(ix, rows, mesh)
        res = {"coords": (d, s), "rel": rel.numpy(), "ok": ok.numpy(),
               "pull": kv_ops.pull(shard, ix, mesh=mesh).numpy(),
               "pull_rep": kv_ops.pull(shard, torch.from_numpy(idx[0]), mesh=mesh,
                                       batch_sharded=False).numpy()}
        for name, kw in (("push", {}), ("push_avg", {"average": True}),
                         ("push_local", {"combine_data": False}),
                         ("push_rep", {"batch_sharded": False})):
            if kw.get("batch_sharded") is False:
                args = (torch.from_numpy(idx[0]), torch.from_numpy(vals[0]))
            else:
                args = (ix, v)
            res[name] = kv_ops.push(shard, *args, mesh=mesh, **kw).numpy()
        new, pulled = kv_ops.push_pull(shard, ix, v, mesh=mesh)
        res["push_pull"] = (new.numpy(), pulled.numpy())
        donated = shard.clone()
        kv_ops.push_donated(donated, ix, v, mesh=mesh)
        res["push_donated"] = donated.numpy()
        kv = KVVector(k=kv_vals[0].shape[-1], num_slots=table.shape[0], hashed=True, name="kv",
                      mesh=mesh, num_server=s_n)
        try:
            for keys, values in zip(kv_keys, kv_vals):
                kv.wait(kv.push(kv.request(channel=0), keys=keys, values=values))
            res["kv_table"] = kv.table(0).clone().numpy()
            res["kv_values"] = kv.values(0, kv_keys[0])
            ts = kv.push_pull(kv.request(channel=0), keys=kv_keys[1], values=kv_vals[1])
            res["kv_push_pull"] = kv.wait_pull(ts).numpy()
        finally:
            kv.executor.stop()
        res.update(helpers(mesh, table))
        out.append(res)
    return out


def helpers(mesh, table):
    """The data-row and layout helpers on one rank of ``mesh``."""
    from parameter_server_tpu_torch.parallel import partition

    d, s = mesh.coords
    d_n = mesh.shape["data"]
    part = partition.for_mesh(mesh)
    shards = part.shard({"z": table[:, 0], "step": np.float32(3)})
    state = meshlib.init_sharded(lambda n, dev: {"z": torch.zeros(n, device=dev)}, mesh,
                                 table.shape[0])
    return {
        "axis_index": (meshlib.axis_index("data", mesh), meshlib.axis_index("server", mesh)),
        "local_shards": distributed.local_data_shards(mesh),
        "local_rows": distributed.local_from_global(
            mesh, {"y": np.arange(d_n * 3).reshape(d_n, 3)})["y"],
        "local_rows_t": distributed.local_from_global(
            mesh, {"y": np.arange(2 * d_n).reshape(2, d_n)}, axis_dim=1)["y"],
        "global_rows": distributed.global_from_local(
            mesh, {"y": torch.tensor([[10 * d + s]])})["y"].numpy(),
        "shard_z": shards["z"].numpy(), "step": float(shards["step"]),
        "gathered_z": part.gather(shards)["z"],
        "init_rows": tuple(state["z"].shape),
    }


def store_and_rows(tag):
    """post/fetch a frame over the rendezvous store; then the row check
    passes on agreeing batches and raises on a disagreeing one."""
    rank = torch.distributed.get_rank()
    distributed.post_bytes(f"{tag}/{rank}", f"hello from {rank}".encode())
    peers = [distributed.fetch_bytes(f"{tag}/{r}").decode()
             for r in range(torch.distributed.get_world_size())]
    mesh = meshlib.make_mesh(1, 2, device="cpu")
    column = meshlib.make_mesh(2, 1, device="cpu")
    same = {"y": np.arange(4, dtype=np.float32)}
    distributed.assert_row_agrees(mesh, same)
    # over a data group: the rows may differ, the shared parts may not
    distributed.assert_row_agrees(column, {"y": same["y"] + column.data_index}, shared=same)
    caught = []
    for m, rows, shared in ((mesh, {"y": same["y"] + mesh.server_index}, None),
                            (column, same, {"u": same["y"] + column.data_index})):
        try:
            distributed.assert_row_agrees(m, rows, shared=shared)
            caught.append(None)
        except ValueError as e:
            caught.append(str(e))
    return peers, mesh.backend, caught


def linear_cli(argv):
    """The port's linear CLI on this rank."""
    from parameter_server_tpu_torch.apps.linear import main as tmain

    return tmain.main(argv)


def fail_on(rank_to_fail):
    """Rank ``rank_to_fail`` raises; every other rank waits in a
    collective that will never complete."""
    if torch.distributed.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    torch.distributed.barrier()
    return "unreachable"


def sleep_for(seconds):
    import time

    time.sleep(seconds)
    return seconds
