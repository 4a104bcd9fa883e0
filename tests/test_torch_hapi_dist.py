"""The distributed ``paddle.Model`` of the PyTorch port
(``hapi_model.py``: ``prepare``'s fleet branch, ``comm_traffic``), the
collective records behind it (``distributed/comm_analysis.py``,
``collective.record_collectives``) and ``fleet.save_persistables``,
against the reference.

One spawn of 2 gloo ranks at dp 2 fits tests/test_grad_comm.py's ``_Net``
(bridged weights) through ``Model.fit``, reports ``comm_traffic`` under
the f32 and the bf16 gradient wire, saves and restores its parameters
with ``save_persistables``, and prepares a ``PipelineLayer`` network at
pp 2. Meanwhile this process runs the reference's ``Model`` on its CPU
mesh (``fleet.init`` at dp 8): the same per-step losses, and its
``comm_traffic`` (tests/test_grad_comm.py::
test_hapi_model_comm_traffic_report) for the report's keys. Both
packages' summaries take the same record dicts and must agree."""
import numpy as np
import pytest

from paddle_tpu.distributed import comm_analysis as ref_ca
from paddle_tpu_torch.distributed import comm_analysis as ca

from torch_port_utils import (HAPI_VOCAB, hapi_dist_job, hapi_net,
                              hapi_rows, join_ranks, no_mesh, numpy_state,
                              spawn_ranks)

LR = 1e-2
ROWS, BATCH, T = 32, 8, 4
# f32 losses of the same steps (a dp mean against one over the batch)
LOSS_RTOL = 2e-5


def _data():
    rng = np.random.RandomState(0)
    return dict(ids=rng.randint(0, HAPI_VOCAB, (ROWS, T)).astype(np.int64),
                labels=np.random.RandomState(1).randint(
                    0, HAPI_VOCAB, (ROWS, T, 1)).astype(np.int64),
                batch=BATCH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import paddle_tpu as paddle
    from paddle_tpu.distributed import fleet as ref_fleet
    from paddle_tpu.hapi.callbacks import Callback

    data = _data()
    out = tmp_path_factory.mktemp("hapi_dist")
    with no_mesh():
        paddle.seed(0)
        state = numpy_state(hapi_net(paddle))
    ctx = spawn_ranks(hapi_dist_job, 2, out, state, data, LR, str(out))

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=8)
        ref_fleet.init(is_collective=True, strategy=s)
        paddle.seed(0)
        net = hapi_net(paddle)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.AdamW(learning_rate=LR,
                                             parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss())
        rec = Losses()
        model.fit(hapi_rows(paddle, data["ids"], data["labels"]),
                  batch_size=BATCH, epochs=1, shuffle=False, verbose=0,
                  callbacks=[rec])
        report = model.comm_traffic(
            paddle.to_tensor(data["ids"][:BATCH].astype(np.int32)),
            paddle.to_tensor(data["labels"][:BATCH]))
    ranks = join_ranks(ctx, out)
    return dict(ranks=ranks, ref_losses=rec.losses, ref_report=report,
                step=type(model._train_step).__name__)


def test_fit_at_dp2_matches_the_reference_model(runs):
    assert runs["step"] == "DistTrainStep"
    for r in runs["ranks"]:
        assert r["step"] == "DistTrainStep"
        assert len(r["losses"]) == ROWS // BATCH
        np.testing.assert_allclose(r["losses"], runs["ref_losses"],
                                   rtol=LOSS_RTOL)


def test_comm_traffic_reports_the_reference_keys(runs):
    want = runs["ref_report"]
    for r in runs["ranks"]:
        got = r["traffic_f32"]
        assert sorted(got) == sorted(want)
        # tests/test_grad_comm.py::test_hapi_model_comm_traffic_report
        assert got["grad_exchange"]["n_buckets"] >= 1
        assert got["grad_exchange"]["quantized_fraction"] == 0.0
        assert any("dp" in k for k in got["per_axis"])
        assert set(got["per_axis"]) == {"dp"}
        assert sorted(got["grad_exchange"]["buckets"][0]) == sorted(
            list(want["grad_exchange"]["buckets"][0]) + [
                "bucket", "issued", "ranks"])


def test_comm_traffic_counts_the_gradient_exchange(runs):
    """The f32 exchange moves every parameter's bytes once, in the buckets
    of ``grad_comm.build_buckets`` at the default size, beside two f32
    scalars over dp (the loss's token count, then the step's loss mean);
    the bf16 wire halves the gradients' part."""
    from paddle_tpu_torch.distributed import grad_comm

    for r in runs["ranks"]:
        nb = len(grad_comm.build_buckets(
            r["sizes"], int(grad_comm.resolve_config().bucket_mb * 2 ** 20)))
        grads = 4 * r["n_params"]
        for wire, it in (("f32", 4), ("bf16", 2)):
            ex = r[f"traffic_{wire}"]["grad_exchange"]
            assert ex["n_buckets"] == nb + 2
            assert sorted(c["bucket"] for c in ex["buckets"]
                          if c["bucket"] is not None) == list(range(nb))
            assert all(c["payload_bytes"] == 4 and c["wire_dtype"] == "f32"
                       for c in ex["buckets"] if c["bucket"] is None)
            assert ex["payload_bytes"] == grads * it // 4 + 8
            assert ex["payload_bytes_f32"] == grads + 8
        bf16 = r["traffic_bf16"]["grad_exchange"]
        assert bf16["quantized_fraction"] == pytest.approx(
            1 - (grads // 2 + 8) / (grads + 8))
        wires = r["traffic_bf16"]["per_axis_wire"]["dp"]["wire_dtypes"]
        assert "bf16" in wires
        issued = {c["issued"] for c in bf16["buckets"]}
        assert issued == {"all-gather", "all-reduce"}


RECORDS = [
    dict(kind="all-reduce", payload_bytes=4000, group_size=8, axes=("dp",),
         wire_bytes_per_device=7000, wire_dtype="f32"),
    dict(kind="all-reduce", payload_bytes=1000, group_size=2,
         axes=("dp", "sharding"), wire_bytes_per_device=1000,
         wire_dtype="s8"),
    dict(kind="all-gather", payload_bytes=2048, group_size=2, axes=("mp",),
         wire_bytes_per_device=1024, wire_dtype="bf16"),
    dict(kind="reduce-scatter", payload_bytes=512, group_size=4,
         axes=("sharding",), wire_bytes_per_device=1536, wire_dtype="f32"),
    dict(kind="collective-permute", payload_bytes=64, group_size=2,
         axes=("sep",), wire_bytes_per_device=64, wire_dtype="f32"),
    dict(kind="all-reduce", payload_bytes=4, group_size=2, axes=("self",),
         wire_bytes_per_device=4, wire_dtype=None),
]
SUMMARIES = ["bucket_traffic", "axis_traffic_summary", "axis_wire_summary",
             "axis_payload_summary"]


@pytest.mark.parametrize("fn", SUMMARIES)
def test_summaries_equal_the_reference_on_the_same_records(runs, fn):
    recorded = runs["ranks"][0]["traffic_bf16"]["collectives"]
    for records in (RECORDS, recorded):
        assert getattr(ca, fn)(records) == getattr(ref_ca, fn)(records)


def test_collective_traffic_and_slice_crossing_take_records():
    recs = [dict(r, ranks=[0, 1]) for r in RECORDS[:3]] + [
        dict(RECORDS[3], ranks=[0, 2]), dict(RECORDS[5], group_size=1,
                                             ranks=[0])]
    colls = ca.collective_traffic(recs)
    assert len(colls) == 4  # a one-rank group moves nothing
    cross = ca.slice_crossing_traffic(recs, {0: 0, 1: 0, 2: 1, 3: 1})
    assert [c["kind"] for c in cross] == ["reduce-scatter"]
    assert sorted(cross[0]) == ["axes", "group_size", "kind",
                                "payload_bytes"]


def test_wire_model_is_the_reference_ring_model():
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "all-to-all"):
        line = (f"  %x = f32[1000]{{0}} {kind}(f32[1000]{{0}} %p), "
                "replica_groups=[1,8]<=[8], to_apply=%add\n")
        import jax

        mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("dp",))
        want = ref_ca.collective_traffic(line, mesh)[0]
        assert ca.wire_model_bytes(kind, 4000, 8) == \
            want["wire_bytes_per_device"]


def test_save_persistables_round_trip_and_refusals(runs):
    for r in runs["ranks"]:
        assert r["saved"] == ["emb.weight", "l1.weight", "l1.bias",
                              "l2.weight", "l2.bias", "norm.weight",
                              "norm.bias", "head.weight", "head.bias"]
        assert r["restored"]
        assert r["refusals"] == {"no_dirname": "ValueError",
                                 "program": "NotImplementedError",
                                 "empty": "ValueError"}


def test_pipeline_layer_network_raises(runs):
    for r in runs["ranks"]:
        assert "PipelineLayer" in r["pipeline"]
