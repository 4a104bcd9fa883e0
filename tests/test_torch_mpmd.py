"""The port's MPMD pipeline (``paddle_tpu_torch/distributed/mpmd.py``)
against the reference's (``paddle_tpu/distributed/mpmd.py``), after the
reference's own ``tests/test_mpmd.py`` (the planner and the compile cache
aside: neither is ported).

The reference trains an ``SpmdPipeline`` of 8 ``Linear(16, 16) + Tanh``
blocks under a ``Linear(16, 1)`` head, AdamW at 1e-2, 4 micro-batches,
through its MPMD stages on the 8-device CPU mesh; the port's stages run
the same blocks (the bridged stacked state) on the CPU. The losses and the
final parameters agree within atol 1e-5 (the reference's own gate between
its MPMD and SPMD paths: the same sums, reassociated).
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import mpmd as tmpmd
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    SpmdPipeline as TSpmdPipeline)
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
STEPS = 3


@pytest.fixture(autouse=True)
def cpu_default():
    from paddle_tpu_torch import device

    prev = device._default
    tpaddle.set_device("cpu")
    yield
    device._default = prev


@contextlib.contextmanager
def _ref_mesh(pp=2):
    """The reference's dp x pp mesh over its 8 CPU devices, the previous
    hybrid group and global mesh restored after."""
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed import mesh as _mesh
    from paddle_tpu.distributed.fleet.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)

    prev, prev_mesh = get_hybrid_communicate_group(), _mesh.get_global_mesh()
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 8 // pp, "mp_degree": 1,
                        "pp_degree": pp}
    fleet.init(is_collective=True, strategy=s)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)
        _mesh.set_global_mesh(prev_mesh)


def _x(seed=0):
    return np.random.RandomState(seed).randn(8, 16).astype("float32")


def _ref_run(sched, widths, n_layers=8, seed=0, **kw):
    """The reference's MPMD trajectory: (losses, state of the stack and
    head after STEPS steps, initial state)."""
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import (
        SpmdPipeline)
    from paddle_tpu.distributed.mpmd import MpmdPipeline
    from paddle_tpu.framework.op import raw

    def state(m):
        return {k: np.asarray(raw(v)).copy()
                for k, v in m.state_dict().items()}

    with _ref_mesh():
        paddle.seed(seed)
        pipe = SpmdPipeline(
            [nn.Sequential(nn.Linear(16, 16), nn.Tanh())
             for _ in range(n_layers)], num_stages=2, num_microbatches=4,
            num_virtual_stages=1, schedule=sched)
        paddle.seed(seed + 100)
        head = nn.Linear(16, 1)
        init = (state(pipe), state(head))
        opt = paddle.optimizer.AdamW(
            learning_rate=1e-2,
            parameters=pipe.parameters() + head.parameters())
        mp = MpmdPipeline(pipe, widths, head=head, schedule=sched, **kw)
        losses = []
        for _ in range(STEPS):
            losses.append(mp.train_batch(_x(seed)))
            opt.step()
            opt.clear_grad()
        return losses, (state(pipe), state(head)), init


def _port_build(init, n_layers=8):
    pipe_state, head_state = init
    pipe = TSpmdPipeline([tnn.Sequential(tnn.Linear(16, 16), tnn.Tanh())
                          for _ in range(n_layers)], num_stages=2,
                         num_microbatches=4, num_virtual_stages=1)
    pipe.load_state_dict({k: torch.from_numpy(v)
                          for k, v in pipe_state.items()})
    head = tnn.Linear(16, 1)
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in head_state.items()})
    opt = tpaddle.optimizer.AdamW(
        learning_rate=1e-2,
        parameters=list(pipe.parameters()) + list(head.parameters()))
    return pipe, head, opt


def _port_run(init, widths, n_layers=8, seed=0, steps=STEPS, **kw):
    pipe, head, opt = _port_build(init, n_layers)
    mp = tmpmd.MpmdPipeline(pipe, widths, head=head, **kw)
    losses = []
    for _ in range(steps):
        losses.append(mp.train_batch(torch.from_numpy(_x(seed))))
        opt.step()
        opt.clear_grad()
    mp.close()
    state = ({k: v.numpy() for k, v in pipe.state_dict().items()},
             {k: v.detach().numpy() for k, v in head.state_dict().items()})
    return losses, state, mp, opt


def _assert_states_close(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=0,
                                       err_msg=k)


@pytest.fixture(scope="module")
def ref_1f1b():
    return _ref_run("1f1b", [2, 2])


@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
def test_mpmd_matches_reference_trajectory(sched, ref_1f1b):
    ref_losses, ref_state, init = (ref_1f1b if sched == "1f1b"
                                   else _ref_run(sched, [2, 2]))
    losses, state, mp, _ = _port_run(init, [2, 2], schedule=sched)
    np.testing.assert_allclose(losses, ref_losses, atol=ATOL, rtol=0)
    _assert_states_close(state, ref_state)
    # stage 0 built fwd + bwd, the last stage its loss_grad, as the
    # reference's stages compile
    assert mp.compile_counts() == {0: 2, 1: 1}
    assert [st.dp for st in mp.stages] == [2, 2]


@pytest.mark.parametrize("widths", [[3, 1], [2, 1]])
def test_unequal_widths_match_reference(widths, ref_1f1b):
    """[3, 1] (the reference's case: 3 does not divide a micro-batch's 2
    rows, so stage 0 runs them whole) and [2, 1] (stage 0 splits each
    micro-batch's rows over its two devices and sums the gradients)."""
    ref_losses, ref_state, init = ref_1f1b
    losses, state, mp, _ = _port_run(init, widths)
    np.testing.assert_allclose(losses, ref_losses, atol=ATOL, rtol=0)
    _assert_states_close(state, ref_state)
    assert [st.dp for st in mp.stages] == widths
    x = mp.stages[0].put_batch(torch.zeros(2, 16))
    assert len(x) == (2 if widths[0] == 2 else 1)


def test_devices_past_the_first_run_a_weight_copy(ref_1f1b):
    """A stage whose devices differ from its first (one CPU device under
    two names here: ``cpu:0`` holds the weights, the chunks land on
    ``cpu``) runs its row chunks on copies of its weights and sums their
    gradients into the weights' ``.grad``: the reference's trajectory."""
    ref_losses, ref_state, init = ref_1f1b
    devices = [torch.device("cpu", 0), torch.device("cpu"),
               torch.device("cpu")]
    losses, state, mp, _ = _port_run(init, [2, 1], devices=devices)
    np.testing.assert_allclose(losses, ref_losses, atol=ATOL, rtol=0)
    _assert_states_close(state, ref_state)
    assert list(mp.stages[0]._replicas) == [torch.device("cpu")]


def test_custom_layer_split_matches_reference():
    ref_losses, ref_state, init = _ref_run("1f1b", [3, 1], n_layers=6,
                                           layer_split=[5, 1])
    losses, state, mp, _ = _port_run(init, [3, 1], n_layers=6,
                                     layer_split=[5, 1])
    np.testing.assert_allclose(losses, ref_losses, atol=ATOL, rtol=0)
    _assert_states_close(state, ref_state)
    assert [len(st.positions) for st in mp.stages] == [5, 1]


def test_layer_split_validation_and_unported_knobs():
    pipe = TSpmdPipeline([tnn.Sequential(tnn.Linear(16, 16), tnn.Tanh())
                          for _ in range(6)], num_stages=2)
    head = tnn.Linear(16, 1)
    for bad in ([6], [4, 1], [0, 6], [2, 2, 2]):
        with pytest.raises(ValueError, match="layer_split"):
            tmpmd.MpmdPipeline(pipe, [2, 2], head=head, layer_split=bad)
    with pytest.raises(NotImplementedError, match="A.8"):
        tmpmd.MpmdPipeline(pipe, [1, 1], head=head, cache_dir="/nowhere")
    with pytest.raises(ValueError, match="zero_bubble"):
        tmpmd.MpmdPipeline(pipe, [1, 1], head=head, schedule="zero_bubble")


@pytest.mark.parametrize("wire", ["raw", "f32"])
def test_tcp_wire_bit_equal_to_local(wire, ref_1f1b):
    init = ref_1f1b[2]
    local, s_local, _, _ = _port_run(init, [2, 2], steps=2,
                                     transport="local", wire="raw")
    tcp, s_tcp, mp, _ = _port_run(init, [2, 2], steps=2, transport="tcp",
                                  wire=wire)
    assert local == tcp
    for a, b in zip(s_local, s_tcp):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    # 2 steps x 4 micro-batches x 2 directions of a [2, 16] f32 tensor
    assert mp.boundary_bytes() == 2 * 4 * 2 * 2 * 16 * 4


def test_resize_rebuilds_only_its_stage(ref_1f1b):
    _, _, mp, _ = _port_run(ref_1f1b[2], [2, 2], steps=1)
    before = mp.compile_counts()
    assert before == {0: 2, 1: 1}
    mp.resize_stage(1, 1)
    mp.train_batch(torch.from_numpy(_x()))
    after = mp.compile_counts()
    assert after[0] == before[0], "the unresized stage 0 rebuilt"
    assert after[1] > before[1], "the resized stage 1 kept a stale build"
    assert [st.dp for st in mp.stages] == [2, 1]


def test_boundary_replay_is_idempotent():
    up, down = tmpmd.local_boundary(0, wire="f32")
    a = [np.full((2, 3), i, np.float32) for i in range(3)]
    up.send(a[0], mb=0)
    up.send(a[1], mb=1)
    for i in range(2):
        arr, meta = down.recv(timeout=5)
        assert meta["mb"] == i
        np.testing.assert_array_equal(arr.numpy(), a[i])
    up._pump()  # drain the cumulative acks
    assert up.unacked() == 0 and down.acked_watermark() == 2
    # an unacked frame + a reconnect: the tail replays, exactly once
    up.send(a[2], mb=2)
    up._chan._rx.put({"t": "_reconnect"})
    up._pump()
    arr, meta = down.recv(timeout=5)
    assert meta["mb"] == 2
    np.testing.assert_array_equal(arr.numpy(), a[2])
    with pytest.raises(TimeoutError):
        down.recv(timeout=0.2)  # the replayed duplicate was dropped


def test_tcp_boundary_replays_after_a_dropped_connection():
    """The connection drops under the sender: the client redials, both
    ends see the reconnect, the unacked tail is sent again and the
    receiver takes each micro-batch exactly once."""
    import time

    up, down = tmpmd.tcp_boundary(0, wire="raw")
    try:
        a = [np.full((256, 64), i, np.float32) for i in range(4)]
        up.send(a[0], mb=0)
        up.send(a[1], mb=1)
        arr, meta = down.recv(timeout=10)
        assert meta["mb"] == 0
        tmpmd._close(up._chan._sock)  # the connection dies
        deadline = time.monotonic() + 10
        while up._chan._gen < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert up._chan._gen == 2, "the client never redialed"
        up.send(a[2], mb=2)
        for i in (1, 2):
            for _ in range(50):  # the sender's pumps replay its tail
                up._pump()
                time.sleep(0.01)
                if down._seqs.pending(down._recv_ch) or i == 2:
                    break
            arr, meta = down.recv(timeout=10)
            assert meta["mb"] == i
            np.testing.assert_array_equal(arr.numpy(), a[i])
        # the cotangent direction works on the new connection
        down.send(a[3], mb=3)
        arr, meta = up.recv(timeout=10)
        assert meta["mb"] == 3
        with pytest.raises(TimeoutError):
            down.recv(timeout=0.3)  # nothing was taken twice
    finally:
        up.close()
        down.close()


def test_boundary_seek_fast_forwards_consumer():
    up, down = tmpmd.local_boundary(1, wire="f32")
    for i in range(3):
        up.send(np.full((1,), i, np.float32), mb=i)
    down.seek(2)  # a restore: micro-batches 0-1 were consumed before
    arr, meta = down.recv(timeout=5)
    assert meta["mb"] == 2 and float(arr[0]) == 2.0


def test_boundary_keeps_bf16_tensors():
    up, down = tmpmd.local_boundary(0, wire="raw")
    x = torch.randn(3, 4).to(torch.bfloat16)
    up.send(x, mb=0)
    got, _ = down.recv(timeout=5)
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)


def test_stage_shards_resume_bit_equal(tmp_path, ref_1f1b):
    init = ref_1f1b[2]
    pipe, head, opt = _port_build(init)
    mp = tmpmd.MpmdPipeline(pipe, [2, 2], head=head)
    x = torch.from_numpy(_x(3))
    for _ in range(2):
        mp.train_batch(x)
        opt.step()
        opt.clear_grad()
    mp.save_shards(str(tmp_path), opt)
    cont = []
    for _ in range(2):
        cont.append(mp.train_batch(x))
        opt.step()
        opt.clear_grad()
    # a fresh process's pipeline: the initial weights, then the restore
    pipe2, head2, opt2 = _port_build(init)
    mp2 = tmpmd.MpmdPipeline(pipe2, [2, 2], head=head2)
    assert mp2.restore_shards(str(tmp_path), opt2) == 2
    resumed = []
    for _ in range(2):
        resumed.append(mp2.train_batch(x))
        opt2.step()
        opt2.clear_grad()
    assert resumed == cont  # bit-equal: the same floats, not just close
    for (k, a), b in zip(pipe.state_dict().items(),
                         pipe2.state_dict().values()):
        assert torch.equal(a, b), k


def test_parse_stage_widths_and_wire_env(monkeypatch):
    assert tmpmd.parse_stage_widths("3,1") == [3, 1]
    assert tmpmd.parse_stage_widths("") is None
    monkeypatch.setenv(tmpmd.ENV_STAGES, "2, 2")
    assert tmpmd.parse_stage_widths() == [2, 2]
    monkeypatch.setenv(tmpmd.ENV_WIRE, "nope")
    with pytest.raises(ValueError, match="nope"):
        tmpmd.resolve_wire()


def test_live_stage_stats_raise_only_when_asked(monkeypatch, tmp_path,
                                                ref_1f1b):
    _, _, mp, _ = _port_run(ref_1f1b[2], [1, 1], steps=1)
    stats = mp.export_stage_stats()
    assert sorted(stats) == ["0", "1"]
    assert all(0.0 <= s["idle_fraction"] <= 1.0 for s in stats.values())
    from paddle_tpu_torch.observability import live

    live.note_stage_stats({})  # a no-op while the plane is off
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_LIVE_TELEMETRY", "1")
    try:
        # the plane on: the stats stream into the live plane, and the
        # aggregator's health doc shows the stages' imbalance
        exported = mp.export_stage_stats()
        assert live.stage_stats() == {
            s: {k: round(float(v), 6) for k, v in rec.items()}
            for s, rec in exported.items()}
        agg = live.LiveAggregator(tail_local=True)
        agg._poll_local(0.0)
        imb = agg.health(now=0.0)["stages"]
        assert sorted(imb["idle_fraction"]) == ["0", "1"]
        fr = [live.stage_stats()[s]["idle_fraction"] for s in ("0", "1")]
        assert imb["imbalance"] == pytest.approx(max(fr) - min(fr), abs=2e-6)
    finally:
        monkeypatch.delenv("PADDLE_TPU_LIVE_TELEMETRY")
        with live._stage_lock:
            live._stage_stats.clear()


def test_launch_cli_exports_stage_widths(tmp_path):
    from paddle_tpu.distributed.launch import build_parser as ref_parser

    from paddle_tpu_torch.distributed.launch import build_parser

    args = build_parser().parse_args(["--mpmd_stages", "3,1", "x.py"])
    assert args.mpmd_stages == ref_parser().parse_args(
        ["--mpmd_stages", "3,1", "x.py"]).mpmd_stages == "3,1"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--mpmd_stages"])  # value required
    script = tmp_path / "show.py"
    script.write_text(
        "import os\nfrom paddle_tpu_torch.distributed import mpmd\n"
        "print('widths', mpmd.parse_stage_widths())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    launch = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
    p = subprocess.run(launch + ["--mpmd_stages", "3, 1", str(script)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "widths [3, 1]" in p.stdout
    p = subprocess.run(launch + ["--mpmd_stages", "3,0", str(script)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "mpmd_stages" in p.stderr


# -- the kernels' route: K1 / K2 launches from the stage threads -------------
@pytest.fixture
def counted_kernels(monkeypatch):
    """The flash route with the kernels' plain versions standing in for the
    kernels, counting under the kernels' lock as they do."""
    monkeypatch.setattr(fa, "_is_cuda", lambda q: True)
    for name, counter in (("forward", "launches_fwd"),
                          ("bwd_dq", "launches_dq"),
                          ("bwd_dkv", "launches_dkv")):
        plain = getattr(fa, f"flash_attention_{name}_plain")

        def launch(*a, _plain=plain, _counter=counter, **k):
            with fa._count_lock:
                setattr(fa, _counter, getattr(fa, _counter) + 1)
            return _plain(*a, **k)

        monkeypatch.setattr(fa, f"flash_attention_{name}_cuda", launch)
        monkeypatch.setattr(fa, counter, 0)
    monkeypatch.setattr(tattn, "_FLASH_ON_CPU", True)


@pytest.mark.parametrize("widths", [[1, 1], [2, 1]])
def test_gpt_blocks_launch_k1_k2_per_stage(counted_kernels, widths):
    """GPT decoder blocks as stages: K1 runs once a layer in each forward
    (twice on a non-last stage: ``bwd`` recomputes) and K2a / K2b once in
    each backward, per row chunk of a stage's width; the MPMD losses equal
    the fold's within the f32 tolerance."""
    from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                  GPTForCausalLM)

    layers, m, steps = 4, 4, 2
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=layers,
                    num_attention_heads=4, max_position_embeddings=64,
                    hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)

    def build():
        lm = GPTForCausalLM(cfg, device="cpu", seed=3)
        pipe = TSpmdPipeline(list(lm.gpt.decoder), num_stages=2,
                             num_microbatches=m)
        head = tnn.Sequential(lm.gpt.final_layernorm, lm.lm_head) \
            if not cfg.tie_word_embeddings else lm.gpt.final_layernorm
        opt = tpaddle.optimizer.AdamW(
            learning_rate=1e-3,
            parameters=list(pipe.parameters()) + list(head.parameters()))
        return pipe, head, opt

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((8, 16, 32)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((8, 16, 32)), dtype=torch.float32)

    def loss_fn(h, lab):
        return ((h - lab) ** 2).mean()

    pipe, head, opt = build()
    fold = []
    for _ in range(steps):
        loss = loss_fn(head(pipe(x)), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        fold.append(float(loss.detach()))
    pipe, head, opt = build()
    mp = tmpmd.MpmdPipeline(pipe, widths, head=head, loss_fn=loss_fn)
    for k in ("fwd", "dq", "dkv"):
        setattr(fa, f"launches_{k}", 0)
    got = []
    for _ in range(steps):
        got.append(mp.train_batch(x, y))
        opt.step()
        opt.clear_grad()
    np.testing.assert_allclose(got, fold, rtol=1e-5, atol=0)
    per = [dp for dp in widths]  # 2 rows a micro-batch: each width splits
    k1 = steps * m * (2 * per[0] * 2 + per[1] * 2)
    k2 = steps * m * (per[0] * 2 + per[1] * 2)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == (k1, k2, k2)
