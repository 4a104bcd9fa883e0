"""Online weight epochs of the PyTorch port (``serving/online.py`` and
the engine's versioned weights), the reference's ``tests/test_online.py``
case for case on the port's tiny GPT (CPU):

* the ``wt`` codec: frames, acks and the bf16 wire's rounding, equal to
  the reference's on the same array;
* a flip mid-flight: a request in flight when the epoch flips finishes
  equal to a run on its admission epoch, the next admission equal to a
  fresh engine on the new (bf16-wire-rounded) weights, and no epoch stays
  pinned after the window;
* delta skipping and exactly-once replay, rollback before commit (also
  at the commit fence), ``recover`` by fence, ``rollout_round``;
* the wire flip through an ``EngineWorker`` (slow, as in the reference);
* only ``apply_wt_frame`` calls ``promote_epoch`` / ``discard_shadow``: a
  scan of the package's syntax trees (the reference's
  ``check_robustness.py`` rule 9).
"""
import ast
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.fleet.supervisor import (FlipJournal,
                                                           WEIGHT_FENCES)
from paddle_tpu_torch.inference.engine import DecodeEngine, SamplingParams
from paddle_tpu_torch.serving.online import (EngineSink, OnlineCoordinator,
                                             WireEngineSink, apply_wt_frame,
                                             rollout_round)
from paddle_tpu_torch.serving.transport import (decode_wt_frame,
                                                encode_wt_ack,
                                                encode_wt_frame)
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

from torch_port_utils import VOCAB, tiny_gpt_kwargs

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"


@pytest.fixture(scope="module")
def model():
    m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs()), device="cpu", seed=7)
    m.eval()
    return m


def _engine(model, slots=2):
    return DecodeEngine(model, device="cpu", num_slots=slots, max_length=64)


def _prompts(b, t, seed=0):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, t))


def _epoch0(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _perturbed(params, scale=0.01):
    return {n: v + scale * torch.sign(v) for n, v in params.items()}


def _restore(model, params):
    for n, p in model.named_parameters():
        p.data = params[n].to(p.dtype).clone()


def _run(eng, prompt, n):
    rid = eng.submit(prompt, SamplingParams(max_new_tokens=n))
    eng.run()
    return eng.result(rid)


def test_wt_frame_roundtrip_matches_reference():
    import jax.numpy as jnp

    from paddle_tpu.serving import transport as ref_transport

    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    fr = encode_wt_frame("wt", 3, "leaf", 2, name="w", arr=x, wire="bf16",
                         meta={"spec": [["dp"], []]})
    kind, epoch, name, arr, meta = decode_wt_frame(fr)
    assert (kind, epoch, name) == ("leaf", 2, "w")
    assert meta == {"spec": [["dp"], []]}
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(arr, want)
    _, _, _, ref_arr, _ = ref_transport.decode_wt_frame(
        ref_transport.encode_wt_frame("wt", 3, "leaf", 2, name="w", arr=x,
                                      wire="bf16"))
    np.testing.assert_array_equal(arr, ref_arr)
    for k in ("begin", "swap", "discard"):
        got = decode_wt_frame(encode_wt_frame("wt", 0, k, 5))
        assert got == (k, 5, None, None, {})
    with pytest.raises(ValueError, match="kind"):
        encode_wt_frame("wt", 0, "flip", 1)
    with pytest.raises(ValueError, match="need name and arr"):
        encode_wt_frame("wt", 0, "leaf", 1)
    assert encode_wt_ack("wt", 7, 2, applied=True) == \
        ref_transport.encode_wt_ack("wt", 7, 2, applied=True)
    ack = encode_wt_ack("wt", 8, 2, applied=True, kind="begin", live=1)
    assert ack["kind"] == "begin" and ack["live"] == 1


def test_bf16_leaf_travels_as_its_words():
    """A bf16 leaf (a decorated model's) goes raw and lands bit for bit."""
    m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs()), device="cpu", seed=3)
    from paddle_tpu_torch import amp

    amp.decorate(m, level="O2")
    eng = _engine(m)
    name, p = next(iter(m.named_parameters()))
    new = (p.detach().float() * 1.5).bfloat16()
    assert apply_wt_frame(eng, encode_wt_frame("wt", 0, "begin", 1))[
        "applied"]
    fr = encode_wt_frame("wt", 1, "leaf", 1, name=name, arr=new)
    assert fr["x"]["wire"] == "raw" and fr["x"]["x"].dtype == np.int16
    assert apply_wt_frame(eng, fr)["applied"]
    assert apply_wt_frame(eng, encode_wt_frame("wt", 2, "swap", 1))[
        "applied"]
    assert p.dtype == torch.bfloat16 and torch.equal(p.detach(), new)


def test_flip_mid_flight_equal_on_both_epochs(model, tmp_path):
    e0 = _epoch0(model)
    try:
        ids = _prompts(3, 7, seed=1)
        eng = _engine(model, slots=4)
        coord = OnlineCoordinator(FlipJournal(str(tmp_path)),
                                  {"engine0": EngineSink(eng)})
        e1 = _perturbed(e0)
        ra = eng.submit(ids[1], SamplingParams(max_new_tokens=20))
        for _ in range(5):
            eng.step()  # ra is mid-decode on epoch 0
        entry = coord.publish_epoch(1, e1)
        assert entry["outcome"] == "committed" and entry["leaves"] > 0
        assert eng.weight_epoch == 1
        rb = eng.submit(ids[2], SamplingParams(max_new_tokens=12))
        eng.run()  # mixed-epoch window: ra pinned on 0, rb on 1
        out_a, out_b = eng.result(ra), eng.result(rb)
        assert eng.stats()["pinned_epochs"] == []
        assert eng.stats()["weight_epoch"] == 1
        _restore(model, e0)
        np.testing.assert_array_equal(_run(_engine(model), ids[1], 20),
                                      out_a)
        # epoch 1 is the bf16 wire's rounding of e1, as staged
        _restore(model, {n: v.bfloat16().float() for n, v in e1.items()})
        np.testing.assert_array_equal(_run(_engine(model), ids[2], 12),
                                      out_b)
    finally:
        _restore(model, e0)


def test_flip_drops_prefix_blocks_of_the_old_epoch(model, tmp_path):
    """A request admitted after the flip whose prompt shares full page
    blocks with one admitted before it recomputes them on the new weights
    (the registry's pages hold epoch 0's KV), equal to a fresh engine on
    epoch 1."""
    e0 = _epoch0(model)
    try:
        ids = _prompts(2, 40, seed=5)
        shared = np.concatenate([ids[0][:32], ids[1][32:]])
        eng = _engine(model, slots=4)
        coord = OnlineCoordinator(FlipJournal(str(tmp_path)),
                                  {"engine0": EngineSink(eng)})
        e1 = _perturbed(e0)
        ra = eng.submit(ids[0], SamplingParams(max_new_tokens=20))
        for _ in range(3):
            eng.step()  # ra mid-decode on epoch 0, its 2 blocks registered
        assert eng.stats()["prefix_hit_tokens"] == 0
        assert coord.publish_epoch(1, e1)["outcome"] == "committed"
        rb = eng.submit(shared, SamplingParams(max_new_tokens=12))
        eng.run()
        assert eng.stats()["prefix_hit_tokens"] == 0
        out_b = eng.result(rb)
        _restore(model, {n: v.bfloat16().float() for n, v in e1.items()})
        np.testing.assert_array_equal(_run(_engine(model), shared, 12),
                                      out_b)
        # after the flip the new epoch's blocks are shared again
        rc = eng.submit(shared, SamplingParams(max_new_tokens=12))
        eng.run()
        assert eng.stats()["prefix_hit_tokens"] == 32
        np.testing.assert_array_equal(eng.result(rc), out_b)
    finally:
        _restore(model, e0)


def test_delta_skipping_and_replay_exactly_once(model, tmp_path):
    e0 = _epoch0(model)
    try:
        eng = _engine(model)
        journal = FlipJournal(str(tmp_path))
        coord = OnlineCoordinator(journal, {"engine0": EngineSink(eng)})
        e1 = _perturbed(e0)
        first = coord.publish_epoch(1, e1)
        assert first["leaves"] == len(e1)
        assert first["bytes"] == sum(v.numel() * 4 for v in e1.values())
        # the same values as epoch 2: every leaf digest-equal, none sent
        second = coord.publish_epoch(2, e1)
        assert second["leaves"] == 0 and eng.weight_epoch == 2
        leaf = next(iter(e1))
        for seq, kind, kw in ((99, "begin", {}),
                              (100, "leaf", dict(name=leaf, arr=e1[leaf])),
                              (101, "swap", {})):
            assert not apply_wt_frame(eng, encode_wt_frame(
                "wt", seq, kind, 2, **kw))["applied"]
        assert eng.weight_epoch == 2
        assert coord.ensure_epoch(2, e1)["outcome"] == "already_current"
        assert [(h["id"], h["outcome"])
                for h in journal.weight_history()] == [
            ("wt-1", "committed"), ("wt-2", "committed")]
    finally:
        _restore(model, e0)


def test_pre_commit_failure_rolls_back(model, tmp_path):
    e0 = _epoch0(model)
    try:
        eng = _engine(model)
        journal = FlipJournal(str(tmp_path))
        coord = OnlineCoordinator(journal, {"engine0": EngineSink(eng)})
        bad = dict(_perturbed(e0))
        bad["not.a.leaf"] = np.zeros((2, 2), np.float32)
        with pytest.raises(KeyError):
            coord.publish_epoch(1, bad)
        assert eng.weight_epoch == 0 and eng._shadow is None
        assert journal.pending_weights() is None
        assert journal.weight_history()[-1]["outcome"] == "rolled_back"
        good = coord.publish_epoch(1, _perturbed(e0))
        assert good["outcome"] == "committed"
        assert good["leaves"] == len(e0) and eng.weight_epoch == 1
    finally:
        _restore(model, e0)


def test_commit_fence_failure_does_not_fake_known_epoch(model, tmp_path):
    e0 = _epoch0(model)
    try:
        eng = _engine(model)
        journal = FlipJournal(str(tmp_path))
        sink = EngineSink(eng)
        coord = OnlineCoordinator(journal, {"engine0": sink})
        real = journal.advance_weights

        def flaky(doc, fence):
            if fence == "commit":
                raise RuntimeError("injected commit-fence failure")
            return real(doc, fence)

        journal.advance_weights = flaky
        with pytest.raises(RuntimeError, match="commit-fence"):
            coord.publish_epoch(1, _perturbed(e0))
        journal.advance_weights = real
        assert eng.weight_epoch == 0 and eng._shadow is None
        assert sink.known_epoch == 0
        assert journal.weight_history()[-1]["outcome"] == "rolled_back"
        out = coord.ensure_epoch(1, _perturbed(e0))
        assert out["outcome"] == "committed"
        assert eng.weight_epoch == 1 and sink.known_epoch == 1
    finally:
        _restore(model, e0)


def test_recover_classifies_by_commit_fence(model, tmp_path):
    e0 = _epoch0(model)
    try:
        eng = _engine(model)
        journal = FlipJournal(str(tmp_path))
        coord = OnlineCoordinator(journal, {"engine0": EngineSink(eng)})

        def crashed_at(last):
            doc = {"id": "wt-1", "epoch": 1, "engines": ["engine0"],
                   "leaves": 0, "wire": "bf16", "bytes": 0, "acked": {}}
            journal.begin_weights(doc)
            for fence in WEIGHT_FENCES[1:WEIGHT_FENCES.index(last) + 1]:
                journal.advance_weights(doc, fence)

        crashed_at("stream")
        assert coord.recover() == "rolled_back"
        assert journal.pending_weights() is None
        crashed_at("swap")
        assert coord.recover() == "rolled_forward"
        out = coord.ensure_epoch(1, _perturbed(e0))
        assert out["outcome"] == "committed" and eng.weight_epoch == 1
        assert coord.recover() is None
    finally:
        _restore(model, e0)


def test_rollout_round_closes_the_loop(model, tmp_path):
    e0 = _epoch0(model)
    try:
        eng = _engine(model)
        coord = OnlineCoordinator(FlipJournal(str(tmp_path)),
                                  {"engine0": EngineSink(eng)})
        seen = {}

        def generate():
            rids = [eng.submit(p, SamplingParams(max_new_tokens=6))
                    for p in _prompts(2, 6, seed=9)]
            eng.run()
            return [eng.result(r) for r in rids]

        def train(rollouts, rewards):
            seen["rewards"] = rewards
            return _perturbed(e0, scale=1e-3 * sum(rewards))

        entry = rollout_round(coord, 1, generate_fn=generate,
                              reward_fn=lambda t: float(len(set(t.tolist()))),
                              train_fn=train)
        assert entry["outcome"] == "committed" and eng.weight_epoch == 1
        assert len(seen["rewards"]) == 2
    finally:
        _restore(model, e0)


@pytest.mark.slow
def test_wire_flip_through_engine_worker(model, tmp_path):
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import EngineWorker

    from conftest import free_port

    e0 = _epoch0(model)
    store = TCPStore(host="127.0.0.1", port=free_port(), is_master=True,
                     timeout=20.0)
    try:
        w = EngineWorker(model, store, num_slots=2, max_length=64,
                         device="cpu")
        sink = WireEngineSink(w._server.addr, w.name)
        coord = OnlineCoordinator(FlipJournal(str(tmp_path)),
                                  {w.name: sink}, ack_timeout_s=10.0)
        stop = threading.Event()

        def drive():
            while not stop.is_set():
                w.poll_once()
                time.sleep(0.001)

        th = threading.Thread(target=drive, daemon=True)
        th.start()
        try:
            entry = coord.publish_epoch(1, _perturbed(e0))
            assert entry["outcome"] == "committed"
            assert w.engine.weight_epoch == 1 and sink.known_epoch == 1
            assert w.engine.occupancy()["weight_epoch"] == 1
            assert coord.ensure_epoch(
                1, _perturbed(e0))["outcome"] == "already_current"
        finally:
            stop.set()
            th.join(2.0)
            sink.close()
    finally:
        store.close()
        _restore(model, e0)


def _epoch_swap_calls(path):
    """(function, method) of each ``.promote_epoch(...)`` /
    ``.discard_shadow(...)`` call in the file at ``path``."""
    tree = ast.parse(path.read_text())
    out = []

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Call) and isinstance(
                    child.func, ast.Attribute) and child.func.attr in (
                        "promote_epoch", "discard_shadow"):
                out.append((f, child.func.attr))
            walk(child, f)

    walk(tree, None)
    return out


def test_only_apply_wt_frame_swaps_epochs(tmp_path):
    calls = {str(p.relative_to(PACKAGE)): _epoch_swap_calls(p)
             for p in PACKAGE.rglob("*.py")}
    calls = {k: v for k, v in calls.items() if v}
    assert calls == {"serving/online.py": [
        ("apply_wt_frame", "promote_epoch"),
        ("apply_wt_frame", "discard_shadow")]}
    rogue = tmp_path / "rogue.py"
    rogue.write_text("def hot_swap(engine, epoch):\n"
                     "    engine.promote_epoch(epoch)\n")
    assert _epoch_swap_calls(rogue) == [("hot_swap", "promote_epoch")]
