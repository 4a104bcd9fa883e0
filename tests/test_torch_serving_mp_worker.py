"""The port's engine worker at ``--mp 2`` (``python -m
paddle_tpu_torch.serving.worker --mp 2 --device cpu``): rank 0 starts its
follower rank, the two form a gloo group and serve one engine sharded
over the kv heads and the vocab, behind the port's ``Router`` in this
process.

- unified: greedy streams of an ``--mp 2`` worker EQUAL the reference's
  single-device ``DecodeEngine`` on the same weights (the worker's
  ``build_worker_model`` loaded into the reference's GPT) and an ``--mp 1``
  worker's on the same requests (two routers, one namespace each);
- disaggregated: an ``--mp 2`` prefill worker hands its KV pages (every kv
  head, gathered over its ranks) to an ``--mp 1`` decode worker, streams
  equal to the reference's;
- the follower prints its record at the stop broadcast: rank 1, the same
  engine counts as rank 0's, and both exit 0;
- ``--mp 3`` on a model of 4 kv heads exits non-zero with the engine's
  ``ValueError``;
- a follower killed while the worker is up makes rank 0 exit non-zero
  (``FollowerLost``) within ``TIMEOUT``.

The workers run with one intra-op thread, as this process, so the CPU
matmuls reduce in the same order."""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import free_port

from paddle_tpu_torch.runtime import TCPStore
from paddle_tpu_torch.serving import Router
from paddle_tpu_torch.serving.worker import (build_arg_parser,
                                             build_worker_model)

from torch_port_utils import no_mesh

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 61
MODEL = ["--vocab", str(VOCAB), "--hidden", "32", "--layers", "2",
         "--heads", "4", "--max-positions", "128", "--model-seed", "7"]
GEOM = ["--slots", "2", "--max-length", "64", "--page-size", "16"]
TIMEOUT = 120
NEW = 8


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n).astype(np.int64) for n in lengths]


UNIFIED = _prompts(1, (20, 33, 17, 25))
DISAGG = _prompts(6, (30, 12, 41, 26))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("PADDLE_TPU_TELEMETRY_DIR", "PADDLE_MASTER",
              "PADDLE_SERVING_MP_RANK"):
        env.pop(k, None)
    return env


def _start(port, ns, log, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
         "--master", f"127.0.0.1:{port}", "--device", "cpu",
         "--namespace", ns, *MODEL, *GEOM, *extra],
        cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL, stderr=log)


def _records(text, key):
    return [json.loads(line)[key] for line in text.splitlines()
            if line.startswith("{" + json.dumps(key))]


def _reference_streams(prompts):
    """The reference's single-device engine on the worker's weights."""
    import paddle_tpu as paddle
    from paddle_tpu.inference import engine as ref_engine
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

    args = build_arg_parser().parse_args([*MODEL, "--device", "cpu"])
    state = {k: v.detach().numpy() for k, v in
             build_worker_model(args).state_dict().items()}
    with no_mesh():
        paddle.seed(0)
        ref = GPTForCausalLM(GPTConfig(
            vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
        ref.set_state_dict(state)
        ref.eval()
        eng = ref_engine.DecodeEngine(ref, attn_kernel="einsum", num_slots=4,
                                      max_length=64, page_size=16)
        rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        eng.run()
        return [np.asarray(eng.result(r)).tolist() for r in rids]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Three namespaces on one store: ``mp2`` (an --mp 2 unified worker),
    ``mp1`` (an --mp 1 unified worker) and ``pd`` (an --mp 2 prefill
    worker and an --mp 1 decode worker), all started at once; the same
    greedy requests through the first two routers, the long-prompt set
    through the third."""
    tmp = tmp_path_factory.mktemp("mp_worker")
    port = free_port()
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=30.0)
    specs = {"mp2": ("mp2", "--mp", "2"), "mp1": ("mp1", "--mp", "1"),
             "pd_prefill": ("pd", "--mp", "2", "--role", "prefill"),
             "pd_decode": ("pd", "--mp", "1", "--role", "decode")}
    logs = {n: open(tmp / f"{n}.log", "w") for n in specs}
    procs = {n: _start(port, s[0], logs[n], *s[1:]) for n, s in specs.items()}
    routers = {"mp2": Router(store, namespace="mp2", seed=5),
               "mp1": Router(store, namespace="mp1", seed=5),
               "pd": Router(store, namespace="pd", seed=5,
                            prefill_threshold_tokens=24)}
    try:
        ref = _reference_streams(UNIFIED + DISAGG)
        # every worker registered and beating before the first request: a
        # router without its prefill worker sends long prompts to decode
        want_alive = {"mp2": 1, "mp1": 1, "pd": 2}
        deadline = time.monotonic() + TIMEOUT
        while any(r.stats()["engines_alive"] < want_alive[ns]
                  or any(e.beat < 1 for e in r._engines.values())
                  for ns, r in routers.items()):
            for n, p in procs.items():
                assert p.poll() is None, (n, (tmp / f"{n}.log").read_text())
            assert time.monotonic() < deadline, "workers did not register"
            for r in routers.values():
                r.pump()
            time.sleep(0.01)
        rids = {ns: [r.submit(p, max_new_tokens=NEW) for p in
                     (DISAGG if ns == "pd" else UNIFIED)]
                for ns, r in routers.items()}
        deadline = time.monotonic() + TIMEOUT
        while any(r.pending() for r in routers.values()):
            for n, p in procs.items():
                assert p.poll() is None, (n, (tmp / f"{n}.log").read_text())
            assert time.monotonic() < deadline, {
                ns: r.stats() for ns, r in routers.items()}
            for r in routers.values():
                r.pump()
            time.sleep(0.002)
        out = {ns: dict(streams=[r.result(i).tolist() for i in rids[ns]],
                        stats=r.stats()) for ns, r in routers.items()}
        for r in routers.values():
            r.shutdown()
        codes = {n: p.wait(60) for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for f in logs.values():
            f.close()
        store.close()
    logs = {n: (tmp / f"{n}.log").read_text() for n in specs}
    return dict(out=out, ref=ref, codes=codes, logs=logs)


def test_mp2_worker_streams_equal_reference_and_mp1_worker(served):
    out, ref = served["out"], served["ref"]
    want = ref[:len(UNIFIED)]
    assert out["mp2"]["streams"] == want
    assert out["mp1"]["streams"] == want
    assert out["mp2"]["stats"]["done"] == len(UNIFIED)


def test_mp2_prefill_worker_hands_off_to_mp1_decode_worker(served):
    out, ref = served["out"], served["ref"]
    assert out["pd"]["streams"] == ref[len(UNIFIED):]
    st = out["pd"]["stats"]
    assert st["done"] == len(DISAGG)
    assert st["disagg_dispatches"] == sum(len(p) >= 24 for p in DISAGG)


def test_mp2_ranks_run_in_lockstep_and_stop_cleanly(served):
    assert all(c == 0 for c in served["codes"].values()), served["codes"]
    for name in ("mp2", "pd_prefill"):
        text = served["logs"][name]
        rank0 = _records(text, "serving_worker")
        assert [r["event"] for r in rank0][-1] == "stop"
        assert rank0[-1]["mp"] == 2 and len(rank0[-1]["followers"]) == 1
        (follower,) = _records(text, "serving_worker_follower")
        assert follower["rank"] == 1
        assert follower["pid"] == rank0[-1]["followers"][0]
        assert follower["engine"] == rank0[-1]["engine"]


def test_mp_that_does_not_divide_the_kv_heads_raises():
    port = free_port()
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=30.0)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
             "--master", f"127.0.0.1:{port}", "--device", "cpu",
             "--mp", "3", *MODEL, *GEOM],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=TIMEOUT)
    finally:
        store.close()
    assert proc.returncode != 0
    assert "ValueError: mp=3 must divide num_kv_heads=4" in proc.stderr


def test_killed_follower_ends_the_worker_non_zero(tmp_path):
    port = free_port()
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=30.0)
    log = open(tmp_path / "w.log", "w")
    proc = _start(port, "kill", log, "--mp", "2")
    try:
        deadline = time.monotonic() + TIMEOUT
        text = ""
        while "followers [" not in text:
            assert proc.poll() is None, text
            assert time.monotonic() < deadline, text
            time.sleep(0.05)
            text = (tmp_path / "w.log").read_text()
        pid = int(text.split("followers [")[1].split("]")[0])
        os.kill(pid, signal.SIGKILL)
        code = proc.wait(TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()
        store.close()
    assert code != 0
    assert "FollowerLost" in (tmp_path / "w.log").read_text()
