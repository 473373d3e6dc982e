"""PyTorch port: the mesh's building blocks against the JAX package.

The port runs one process a mesh position: its side runs in a gloo world
of CPU ranks that the test starts (``parallel/launch.run_world``, one
world for the module, rank functions in ``tests/torch_parallel_ranks.py``);
the JAX side runs in the test process on the suite's 8 virtual CPU
devices. Held here:

- ``make_mesh``'s shape rules and errors, and the partition specs and
  rule matching, against the JAX package's (no world needed);
- ``localize`` per server coordinate, ``kv_ops`` pull / push / push_pull
  in every combine mode (``batch_sharded``, ``average``,
  ``combine_data``), ``index_spec`` and ``scatter_grad_dense``, and
  ``KVVector`` over 2 and 4 server shards: all bit-equal to the JAX
  package (each slot has one owner, so the server psum is an assembly;
  the scatter adds in entry order, as XLA's does on the CPU);
- the store's control-plane frames, the data-row agreement check, and a
  failing rank failing the world instead of hanging it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from parameter_server_tpu.ops import kv_ops as jkv
from parameter_server_tpu.parallel import mesh as jmesh
from parameter_server_tpu.parallel import partition as jpart
from parameter_server_tpu.parameter.kv_vector import KVVector as JKVVector
from parameter_server_tpu.system.postoffice import Postoffice as JPostoffice
from parameter_server_tpu.utils.compat import shard_map
from parameter_server_tpu_torch.ops import kv_ops as tkv
from parameter_server_tpu_torch.parallel import distributed, launch
from parameter_server_tpu_torch.parallel import mesh as tmesh
from parameter_server_tpu_torch.parallel import partition as tpart
from tests import torch_parallel_ranks as ranks

torch.set_num_threads(1)

P_SLOTS, K, N = 64, 2, 40
LAYOUTS = [(2, 2), (1, 4), (2, 4)]  # KVVector over 2 and 4 server shards


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _data():
    rng = np.random.default_rng(7)
    table = (rng.normal(size=(P_SLOTS, K)) * np.exp(rng.normal(size=(P_SLOTS, 1)) * 2)
             ).astype(np.float32)
    idx = rng.integers(0, P_SLOTS, (2, N)).astype(np.int32)
    idx[:, -3:] = P_SLOTS  # the padding sentinel: owned by no shard
    idx[:, :6] = idx[:, 6:12]  # colliding entries: the order of the adds shows
    vals = (rng.normal(size=(2, N, K)) * np.exp(rng.normal(size=(2, N, 1)) * 3)
            ).astype(np.float32)
    kv_keys = [rng.integers(0, 1 << 40, 300) for _ in range(3)]
    kv_vals = [(rng.normal(size=(300, K)) * 4).astype(np.float32) for _ in range(3)]
    return table, idx, vals, kv_keys, kv_vals


@pytest.fixture(scope="module")
def world():
    """One world of 8 CPU ranks runs every port case of the module."""
    data = _data()
    kv = launch.run_world(ranks.kv_cases, 8, args=(LAYOUTS, *data), device_type="cpu",
                          timeout=240)
    store = launch.run_world(ranks.store_and_rows, 2, args=("frames",), device_type="cpu",
                             timeout=120)
    return data, kv, store


def _jax_mesh(d, s):
    return jmesh.make_mesh(num_data=d, num_server=s, devices=jax.devices()[: d * s])


# -- shapes and specs (no world) --


@pytest.mark.parametrize("n,num_data,num_server", [
    (8, None, 1), (8, None, 2), (8, None, 3), (8, None, 6), (8, None, 16), (6, None, 4),
    (8, 2, 2), (8, 4, 2), (8, 1, 8), (1, None, 4),
])
def test_mesh_shape_follows_the_jax_auto_shape(n, num_data, num_server):
    jm = jmesh.make_mesh(num_data=num_data, num_server=num_server, devices=jax.devices()[:n])
    want = (jm.shape[jmesh.DATA_AXIS], jm.shape[jmesh.SERVER_AXIS])
    assert tmesh.mesh_shape(n, num_data, num_server) == want


@pytest.mark.parametrize("num_data,num_server", [(4, 4), (3, 3), (9, 1)])
def test_mesh_too_large_raises_as_jax(num_data, num_server):
    with pytest.raises(ValueError, match="needs"):
        jmesh.make_mesh(num_data=num_data, num_server=num_server, devices=jax.devices())
    with pytest.raises(ValueError, match="needs"):
        tmesh.mesh_shape(8, num_data, num_server)


def test_mesh_without_a_world():
    """One process alone is the 1 x 1 mesh of its device (every
    collective the identity); a larger mesh needs a world."""
    m = tmesh.make_mesh(device="cpu")
    assert (m.shape, m.coords, m.groups, m.backend) == ({"data": 1, "server": 1}, (0, 0), {},
                                                         None)
    x = torch.arange(3.0)
    assert tmesh.psum(x, "data", m) is x and tmesh.all_gather(x, "server", m) is x
    assert tmesh.axis_index("server", m) == 0
    with pytest.raises(ValueError, match="needs 4 > 1"):
        tmesh.make_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="world of 4"):
        tmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS and tmesh.SERVER_AXIS == jmesh.SERVER_AXIS


def test_partition_specs_and_rules_match_jax():
    for name in ("TABLE_SPEC", "BATCH_SPEC", "REPLICATED_SPEC"):
        assert tuple(getattr(tpart, name)) == tuple(getattr(jpart, name))
    for batch_sharded in (True, False):
        assert tuple(tkv.index_spec(batch_sharded)) == tuple(jkv.index_spec(batch_sharded))
    for ndim in range(4):
        for spec in (tpart.TABLE_SPEC, tpart.BATCH_SPEC, tpart.P("server", None, "data")):
            assert tuple(tpart.fit_spec(spec, ndim)) == tuple(jpart.fit_spec(JP(*spec), ndim))
    tree = {"batch": {"y": np.zeros(4), "slots": np.zeros((4, 2))}, "lr": np.float32(1),
            "state": {"z": np.zeros(8), "sqrt_n": np.zeros((8, 3))}, "step": np.zeros(()),
            "layers": [np.zeros((6, 2)), np.zeros(5)]}
    want = jpart.match_partition_rules(jpart.DEFAULT_RULES, tree)
    got = tpart.match_partition_rules(tpart.DEFAULT_RULES, tree)
    flat_w = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, JP))
    flat_g = {}
    tpart.named_tree_map(lambda n, s: flat_g.__setitem__(n, tuple(s)), got,
                         is_leaf=lambda x: isinstance(x, tpart.PartitionSpec))
    assert {jpart.tree_path_to_string(p): tuple(s) for p, s in flat_w} == flat_g
    state = {"z": np.zeros(3), "step": np.zeros(())}
    assert {k: tuple(v) for k, v in tpart.state_partition_spec(state).items()} == {
        k: tuple(v) for k, v in jpart.state_partition_spec(state).items()}
    with pytest.raises(ValueError, match="no partition rule"):
        tpart.match_partition_rules(((r"^x$", tpart.TABLE_SPEC),), {"y": np.zeros(2)})


def test_sharding_cuts_rows_by_coordinate():
    m = tmesh.Mesh(2, 4, "cpu", rank=6)  # coordinates (1, 2)
    table = tpart.Sharding(m, tpart.TABLE_SPEC)
    assert table.local_slices((64, 3)) == (slice(32, 48), slice(None))
    assert tpart.Sharding(m, tpart.BATCH_SPEC).local_shape((10, 5)) == (5, 5)
    assert tpart.for_mesh(m) is tpart.for_mesh(m)
    assert tpart.for_mesh(m).local_data(np.arange(10)).tolist() == [5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="does not split"):
        table.local_slices((10,))


def test_scatter_grad_dense_matches_jax():
    _, idx, vals, _, _ = _data()
    want = jkv.scatter_grad_dense(jnp.asarray(idx[0]), jnp.asarray(vals[0]), P_SLOTS, K)
    got = tkv.scatter_grad_dense(torch.from_numpy(idx[0]), torch.from_numpy(vals[0]), P_SLOTS, K)
    assert np.array_equal(_bits(got.numpy()), _bits(np.asarray(want)))


# -- the kv data plane over a world --


def _jax_kv(layout, table, idx, vals):
    """The JAX package's results on the ``layout`` mesh. Its push of
    data-sharded ids (``batch_sharded=True``) trips its own ``shard_map``
    replication check in this JAX version, so the push reference is the
    JAX push of the data rows' entries, in data order, as replicated ids
    (``batch_sharded=False``) on the ``1 x S`` mesh: what its tiled
    all-gather hands the scatter (``average`` divides them by the data
    rows first, as its body does; with one data row nothing is combined
    and nothing divided)."""
    d, s = layout
    mesh, flat = _jax_mesh(d, s), _jax_mesh(1, s)
    ix = jnp.asarray(idx[:d].reshape(-1))
    v = jnp.asarray(vals[:d].reshape(-1, K))
    t = jnp.asarray(table)
    shard = P_SLOTS // s
    rel, ok = jax.jit(shard_map(lambda i: tuple(x[None] for x in jkv.localize(i, shard)),
                                mesh=mesh, in_specs=JP(), out_specs=(JP("server"), JP("server")),
                                check_vma=False))(jnp.asarray(idx[0]))
    new, pulled = jkv.push_pull(t, ix, v, mesh=flat, batch_sharded=False)
    pushed = np.asarray(jkv.push(t, ix, v, mesh=flat, batch_sharded=False))
    assert np.array_equal(_bits(pushed), _bits(np.asarray(new)))
    out = {"rel": np.asarray(rel), "ok": np.asarray(ok),
           "pull": np.asarray(jkv.pull(t, ix, mesh=mesh)),
           "pull_rep": np.asarray(jkv.pull(t, jnp.asarray(idx[0]), mesh=mesh,
                                           batch_sharded=False)),
           "push": pushed, "push_local": pushed,
           "push_avg": pushed if d == 1 else np.asarray(
               jkv.push(t, ix, v / d, mesh=flat, batch_sharded=False)),
           "push_rep": np.asarray(jkv.push(t, jnp.asarray(idx[0]), jnp.asarray(vals[0]),
                                           mesh=mesh, batch_sharded=False)),
           "push_pull": (np.asarray(new), np.asarray(pulled))}
    return mesh, out


@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_kv_ops_over_the_mesh_bit_equal_to_jax(world, li):
    (table, idx, vals, _, _), kv, _ = world
    d_n, s_n = LAYOUTS[li]
    _, want = _jax_kv(LAYOUTS[li], table, idx, vals)
    rows = P_SLOTS // s_n
    seen = 0
    for res in (r[li] for r in kv):
        if "idle" in res:
            continue
        seen += 1
        d, s = res["coords"]
        if d == 0:  # localize of data row 0's ids, per server coordinate
            assert np.array_equal(res["rel"], want["rel"][s])
            assert np.array_equal(res["ok"], want["ok"][s])
        own = slice(s * rows, (s + 1) * rows)
        assert np.array_equal(_bits(res["pull"]), _bits(want["pull"][d * N:(d + 1) * N]))
        assert np.array_equal(_bits(res["pull_rep"]), _bits(want["pull_rep"]))
        for name in ("push", "push_avg", "push_local", "push_rep"):
            if name == "push_local" and d_n > 1:
                continue  # each data row's own table (the next test)
            assert np.array_equal(_bits(res[name]), _bits(want[name][own])), (name, d, s)
        assert np.array_equal(_bits(res["push_donated"]), _bits(want["push"][own]))
        new, pulled = res["push_pull"]
        assert np.array_equal(_bits(new), _bits(want["push_pull"][0][own]))
        assert np.array_equal(_bits(pulled), _bits(want["push_pull"][1][d * N:(d + 1) * N]))
    assert seen == d_n * s_n


def test_kv_push_without_combine_adds_each_rows_own_entries(world):
    """``combine_data=False`` on a 2 x 2 mesh: the shard of data row d is
    the table plus row d's own entries, bit-equal to the one-card push of
    those entries (held to JAX in ``tests/test_torch_kv_vector.py``)."""
    (table, idx, vals, _, _), kv, _ = world
    for res in (r[0] for r in kv if "idle" not in r[0]):
        d, s = res["coords"]
        want = tkv.push(torch.from_numpy(table), torch.from_numpy(idx[d]),
                        torch.from_numpy(vals[d])).numpy()
        assert np.array_equal(_bits(res["push_local"]), _bits(want[s * 32:(s + 1) * 32]))


@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_kv_vector_over_server_shards_bit_equal_to_jax(world, li):
    (table, _, _, kv_keys, kv_vals), kv, _ = world
    d_n, s_n = LAYOUTS[li]
    JPostoffice.reset()
    jv = JKVVector(mesh=_jax_mesh(d_n, s_n), k=K, num_slots=P_SLOTS, hashed=True, name="j")
    try:
        for keys, values in zip(kv_keys, kv_vals):
            jv.wait(jv.push(jv.request(channel=0), keys=keys, values=values))
        want_table = np.asarray(jv.table(0))
        want_values = jv.values(0, kv_keys[0])
        ts = jv.push_pull(jv.request(channel=0), keys=kv_keys[1], values=kv_vals[1])
        want_pp = np.asarray(jv.wait_pull(ts))
    finally:
        JPostoffice.reset()
    rows = P_SLOTS // s_n
    for res in (r[li] for r in kv if "idle" not in r[li]):
        s = res["coords"][1]
        assert np.array_equal(_bits(res["kv_table"]), _bits(want_table[s * rows:(s + 1) * rows]))
        assert np.array_equal(_bits(res["kv_values"]), _bits(want_values))
        assert np.array_equal(_bits(res["kv_push_pull"]), _bits(want_pp))


@pytest.mark.parametrize("li", range(len(LAYOUTS)))
def test_data_rows_and_layouts_on_each_rank(world, li):
    """Each rank feeds its own data row (the JAX process owns whole
    rows; here a row is its ``num_server`` ranks); ``global_from_local``
    assembles the rows in data order; the table spec cuts rows by server
    coordinate and ``gather`` puts them back; ``init_sharded`` makes only
    the rank's rows; a rank the mesh leaves idle owns no row."""
    (table, _, _, _, _), kv, _ = world
    d_n, s_n = LAYOUTS[li]
    rows = P_SLOTS // s_n
    for rank, res in enumerate(r[li] for r in kv):
        if "idle" in res:
            assert rank >= d_n * s_n and "owns no data-axis rows" in res["idle"]
            continue
        d, s = res["coords"]
        assert res["axis_index"] == (d, s) == divmod(rank, s_n)
        assert res["local_shards"] == 1
        assert res["local_rows"].tolist() == [[3 * d, 3 * d + 1, 3 * d + 2]]
        assert res["local_rows_t"].tolist() == [[d], [d_n + d]]
        assert res["global_rows"].tolist() == [[10 * i + s] for i in range(d_n)]
        assert np.array_equal(res["shard_z"], table[s * rows:(s + 1) * rows, 0])
        assert res["step"] == 3.0
        assert np.array_equal(res["gathered_z"], table[:, 0])
        assert res["init_rows"] == (rows,)


# -- the world itself --


def test_store_frames_row_check_and_backend(world):
    _, _, store = world
    for peers, backend, (row, column) in store:
        assert peers == ["hello from 0", "hello from 1"]
        assert backend == "gloo"
        assert row is not None and "fed different batches" in row
        assert column is not None and "prepped different shared parts" in column


def test_a_rank_without_a_card_raises_unless_told_the_device(monkeypatch):
    """No silent fall back to the CPU: a rank names the card unless the
    launcher names another device type."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device(0)
    assert distributed.rank_device(1, "cpu") == torch.device("cpu")


def test_a_failing_rank_fails_the_world_with_its_traceback():
    with pytest.raises(launch.WorldError, match="rank 1 fails on purpose") as e:
        launch.run_world(ranks.fail_on, 2, args=(1,), device_type="cpu", timeout=120)
    assert "Traceback" in str(e.value)


def test_a_world_past_its_time_limit_is_killed():
    with pytest.raises(launch.WorldError, match="ran past"):
        launch.run_world(ranks.sleep_for, 2, args=(600,), device_type="cpu", timeout=6)
