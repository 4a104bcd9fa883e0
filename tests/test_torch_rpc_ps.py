"""The port's ``distributed.rpc`` and ``distributed.ps`` against the
reference's (``paddle_tpu/distributed/rpc``, ``paddle_tpu/distributed/
ps``), after the reference's ``tests/test_rpc.py`` and
``tests/test_ps_tables.py``: RPC round trips between two processes, the
split table on two gloo ranks against the reference's table on the same
weights, the geo-SGD merge and the host-offloaded AdaGrad rows against the
reference's, and ``fleet``'s PS-mode names.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import free_port
from torch_port_utils import join_ranks, no_mesh, ps_table_job, spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180

WORKER = textwrap.dedent(r"""
    import operator, sys
    import torch
    import paddle_tpu_torch.distributed.rpc as rpc

    master, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    rpc.init_rpc(name=f"worker{rank}", rank=rank, world_size=world,
                 master_endpoint=master)
    me = rpc.get_current_worker_info()
    assert me.name == f"worker{rank}" and me.rank == rank
    infos = rpc.get_all_worker_infos()
    assert [w.rank for w in infos] == list(range(world))
    assert rpc.get_worker_info("worker0").rank == 0
    peers = [w.name for w in infos if w.rank != rank]
    for peer in peers:
        assert rpc.rpc_sync(peer, operator.add, args=(rank, 100)) == rank + 100
    futs = [rpc.rpc_async(p, torch.full, args=((2,), float(rank + 3)))
            for p in peers]
    for f in futs:
        assert torch.equal(f.wait(), torch.full((2,), float(rank + 3)))
    try:
        rpc.rpc_sync(peers[0], operator.truediv, args=(1, 0))
    except ZeroDivisionError:
        pass
    else:
        raise AssertionError("the remote ZeroDivisionError did not arrive")
    rpc.shutdown()
    print(f"RPC_OK={rank}", flush=True)
""")


def test_rpc_sync_and_async_across_two_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    master = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), master, str(r),
                               "2"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"RPC_OK={r}" in out


def test_rpc_needs_init():
    from paddle_tpu_torch.distributed import rpc

    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.rpc_sync("worker0", print)


# -- the split table -------------------------------------------------------------
VOCAB, DIM, LR, PAD = 64, 8, 0.5, 5


def _table_inputs():
    rng = np.random.default_rng(0)
    weight = rng.standard_normal((VOCAB, DIM)).astype("float32")
    ids = rng.integers(0, VOCAB, (4, 12))
    ids[0, :3] = [7, 7, 40]  # a repeated id, one in each half
    ids[1, 0] = PAD
    w_out = rng.standard_normal((4, 12, DIM)).astype("float32")
    return weight, ids, w_out


def test_sharded_table_on_two_ranks_matches_the_reference(tmp_path):
    """Each rank holds half the rows; the lookup (masked, all-reduced),
    its gradient rows and the SGD step equal the reference's table."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import ps as ref_ps
    from paddle_tpu.framework.op import raw

    weight, ids, w_out = _table_inputs()
    ctx = spawn_ranks(ps_table_job, 2, tmp_path, weight, ids, w_out, LR, PAD)
    with no_mesh():
        t = ref_ps.ShardedEmbeddingTable(VOCAB, DIM, padding_idx=PAD)
        t.weight.set_value(weight)
        opt = paddle.optimizer.SGD(learning_rate=LR,
                                   parameters=t.parameters())
        out = t(paddle.to_tensor(ids))
        (out * paddle.to_tensor(w_out)).sum().backward()
        want_out = np.asarray(raw(out))
        want_grad = np.asarray(raw(t.weight.grad))
        opt.step()
        want_rows = np.asarray(raw(t.weight))
        ref_info = ref_ps.table_shard_info(t.weight)
    ranks = join_ranks(ctx, tmp_path)
    for r, got in enumerate(ranks):
        lo, n = got["lo"], VOCAB // 2
        assert lo == r * n
        np.testing.assert_allclose(got["out"], want_out, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["grad"], want_grad[lo:lo + n],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["rows"], want_rows[lo:lo + n],
                                   rtol=0, atol=1e-5)
        info = got["info"]
        assert sorted(info) == sorted(ref_info)
        assert (info["global_rows"], info["num_shards"], info["axis"],
                info["rows_per_shard"]) == (VOCAB, 2, "dp", VOCAB // 2)
    assert np.array_equal(ranks[0]["out"], ranks[1]["out"])


def test_whole_table_and_sparse_embedding():
    from paddle_tpu_torch.distributed import ps

    weight, ids, _ = _table_inputs()
    t = ps.ShardedEmbeddingTable(VOCAB, DIM, padding_idx=PAD, device="cpu")
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(weight))
    out = t(torch.from_numpy(ids))
    want = weight[ids] * (ids != PAD)[..., None]
    assert np.array_equal(out.detach().numpy(), want)
    assert t.shard_info() == {
        "global_rows": VOCAB, "dim": DIM, "num_shards": 1,
        "rows_per_shard": VOCAB, "axis": None,
        "bytes_per_shard": VOCAB * DIM * 4}
    x = torch.from_numpy(ids)

    def call():
        return ps.sparse_embedding(x, (VOCAB, DIM))

    a, b = call(), call()  # one call site: one table, reused
    assert torch.equal(a, b)
    c = ps.sparse_embedding(x, (VOCAB, DIM), name="named_table")
    assert c.shape == (4, 12, DIM)


# -- geo-SGD and the host tier -----------------------------------------------------
def _geo_merge(mod, stores):
    vocab, dim = 16, 4
    base = np.zeros((vocab, dim), "float32")
    s0, s1 = stores
    w0 = mod.GeoSGDCommunicator(base.copy(), s0, worker_id=0, num_workers=2,
                                sync_every=1)
    w1 = mod.GeoSGDCommunicator(base.copy(), s1, worker_id=1, num_workers=2,
                                sync_every=1)
    # w0 trains rows {1, 2}, w1 rows {2, 3}: they overlap on row 2
    w0.table[1] += 1.0
    w0.table[2] += 2.0
    w0.touch([1, 2])
    w1.table[2] += 10.0
    w1.table[3] += 20.0
    w1.touch([2, 3])
    w0.sync()
    w1.sync()
    w0.pull()
    w0.table[5] += 0.5  # unpublished drift survives a pull exactly once
    w0.touch([5])
    w0.pull()
    return w0.table.copy(), w1.table.copy()


def test_geo_merge_equals_the_references():
    from paddle_tpu.distributed import ps as ref_ps

    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.runtime import TCPStore

    s = ref_ps.LocalDeltaStore()
    want = _geo_merge(ref_ps, (s, s))
    s = ps.LocalDeltaStore()
    got = _geo_merge(ps, (s, s))
    master = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=30)
    client = TCPStore("127.0.0.1", master.port, is_master=False, timeout=30)
    try:
        over_tcp = _geo_merge(ps, (ps.TCPDeltaStore(master),
                                   ps.TCPDeltaStore(client)))
    finally:
        client.close()
        master.close()
    for g, t, w in zip(got, over_tcp, want):
        assert np.array_equal(g, w) and np.array_equal(t, w)
    assert want[1][2, 0] == 12.0  # deltas add on the overlap


def test_host_offloaded_adagrad_rows_equal_the_references():
    import jax.numpy as jnp

    from paddle_tpu.distributed import ps as ref_ps

    from paddle_tpu_torch.distributed import ps

    vocab, dim = 50, 8
    rng = np.random.default_rng(0)
    init = rng.standard_normal((vocab, dim)).astype("float32")
    target = rng.standard_normal((vocab, dim)).astype("float32")
    ref = ref_ps.HostOffloadedTable(vocab, dim, lr=0.5,
                                    initializer=init.copy())
    port = ps.HostOffloadedTable(vocab, dim, lr=0.5, initializer=init.copy(),
                                 device="cpu")
    for step in range(4):
        ids = rng.integers(0, vocab, (12,))
        r_rows, r_uniq, r_inv = ref.pull(ids)
        p_rows, p_uniq, p_inv = port.pull(ids)
        assert isinstance(p_rows, torch.Tensor) and p_rows.device.type == "cpu"
        assert np.array_equal(p_uniq, r_uniq) and np.array_equal(p_inv, r_inv)
        assert np.array_equal(p_rows.numpy(), np.asarray(r_rows))
        assert np.array_equal(port.lookup(ids).numpy(),
                              np.asarray(ref.lookup(ids)))
        g = 2 * (np.asarray(r_rows) - target[r_uniq]) / r_rows.size
        ref.push(r_uniq, np.asarray(jnp.asarray(g)))
        port.push(torch.from_numpy(p_uniq), torch.from_numpy(g))
        np.testing.assert_allclose(port.table, ref.table, rtol=0, atol=1e-7)
        np.testing.assert_allclose(port._g2, ref._g2, rtol=0, atol=1e-9)
    sd = port.state_dict()
    port2 = ps.HostOffloadedTable(vocab, dim, device="cpu")
    port2.set_state_dict(sd)
    assert np.array_equal(port2.table, port.table)


# -- fleet's PS-mode names ---------------------------------------------------------
def test_fleet_server_names():
    from paddle_tpu.distributed import fleet as ref_fleet

    from paddle_tpu_torch.distributed import fleet, ps

    for name in ("init_server", "run_server", "init_worker", "stop_worker",
                 "is_server", "is_worker"):
        assert callable(getattr(fleet, name)), name
        assert name in fleet.__all__
    assert fleet.init_server() is None and fleet.run_server() is None
    assert fleet.init_worker() is None and fleet.stop_worker() is None
    assert (fleet.is_server(), fleet.is_worker()) == (
        ref_fleet.is_server(), ref_fleet.is_worker()) == (False, True)
    assert fleet.ps is ps
    role = ps.RoleMakerBase()
    assert (role.is_worker(), role.is_server(), role.server_num()) == (
        True, False, 0)
    assert role.is_first_worker() and role.worker_index() == 0
    assert role.worker_num() == 1
