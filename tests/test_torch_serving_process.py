"""Two engine-worker PROCESSES through the port's CLI
(``python -m paddle_tpu_torch.serving.worker --device cpu``) behind a
router in this process; one worker is SIGKILLed after it acked a done.

Gates: every admitted request completes exactly once (``done`` = requests,
``dispatched`` = requests + ``failover_resubmits``, at least one
resubmit), each stream EQUALS the port's single engine on the same
weights (``build_worker_model`` here with the CLI's arguments) fed the
router's params, and the surviving worker prints its exit record (device
``cpu``, K3 regime counts) after its first result and on the stop
broadcast — the victim only the first. The children run with
this process's thread count, so their CPU matmuls reduce in the same
order. A worker asked for CUDA (the CLI's default) where there is none
exits non-zero.
"""
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

from paddle_tpu_torch.inference.engine import DecodeEngine
from paddle_tpu_torch.runtime import TCPStore
from paddle_tpu_torch.serving import Router
from paddle_tpu_torch.serving.worker import (build_arg_parser,
                                             build_worker_model)

ROOT = Path(__file__).resolve().parents[1]
MODEL = ["--vocab", "61", "--hidden", "32", "--layers", "2", "--heads", "4",
         "--max-positions", "128", "--model-seed", "7"]
GEOM = ["--slots", "2", "--max-length", "64", "--page-size", "16"]
TIMEOUT = 120
GRACE_AFTER_KILL = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny CPU models: the suite runs
    6 test processes at once, and 6 pools of spinning threads slowed this
    file's tests up to 20-fold there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _start(port, name, log):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    env.pop("PADDLE_TPU_TELEMETRY_DIR", None)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
         "--master", f"127.0.0.1:{port}", "--device", "cpu", "--name", name,
         *MODEL, *GEOM], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=log)


def _wait_for_line(path, timeout=10.0):
    deadline = time.monotonic() + timeout
    while '{"serving_worker"' not in path.read_text():
        assert time.monotonic() < deadline, path.read_text()
        time.sleep(0.01)


def test_two_worker_processes_failover_every_request_once(tmp_path):
    port = free_port()
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=30.0)
    logs = {n: open(tmp_path / f"{n}.log", "w") for n in ("w0", "w1")}
    procs = {n: _start(port, n, logs[n]) for n in ("w0", "w1")}
    # a loaded test machine may stall a worker's beats for a while: the
    # liveness window narrows only once the victim is dead
    router = Router(store, queue_limit=16, seed=11, engine_grace_s=60.0)
    try:
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 61, size=n).astype(np.int64)
                   for n in (9, 14, 20, 11, 17, 25)]
        rids = [router.submit(p, max_new_tokens=2 if i < 2 else 24,
                              do_sample=(i % 2 == 1), temperature=0.7,
                              top_k=8) for i, p in enumerate(prompts)]
        deadline = time.monotonic() + TIMEOUT
        victim = None
        while router.pending():
            assert time.monotonic() < deadline, router.stats()
            for n, p in procs.items():
                assert p.poll() is None or n == victim, (
                    n, (tmp_path / f"{n}.log").read_text())
            router.pump()
            if victim is None:
                done = [router._requests[r] for r in rids
                        if router.status(r) == "done"]
                if done:
                    # it acked a done (and printed its first record); it
                    # still holds later requests
                    victim = done[0].engine
                    _wait_for_line(tmp_path / f"{victim}.log")
                    procs[victim].send_signal(signal.SIGKILL)
                    procs[victim].wait(10)
                    router.config.engine_grace_s = GRACE_AFTER_KILL
            time.sleep(0.002)
        st = router.stats()
        assert victim is not None and st["engines_lost"] == 1
        assert st["done"] == len(rids) and st["failed"] == 0
        assert st["failover_resubmits"] >= 1
        assert st["dispatched"] == len(rids) + st["failover_resubmits"]
        router.shutdown()
        survivor = next(n for n in procs if n != victim)
        assert procs[survivor].wait(30) == 0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for f in logs.values():
            f.close()
        store.close()
    records = {}
    for n in procs:
        text = (tmp_path / f"{n}.log").read_text()
        records[n] = [json.loads(line)["serving_worker"]
                      for line in text.splitlines()
                      if line.startswith('{"serving_worker"')]
    # the victim reported its first result before the kill; the survivor
    # its first result and the stop broadcast
    assert [r["event"] for r in records[victim]] == ["first_done"]
    assert [r["event"] for r in records[survivor]] == ["first_done", "stop"]
    for n, recs in records.items():
        rec = recs[-1]
        assert rec["device_type"] == "cpu" and rec["worker"] == n
        assert set(rec["k3"]) == {"launches", "launches_tile",
                                  "launches_split", "launches_decode",
                                  "launches_verify"}
        assert rec["engine"]["total_tokens"] > 0
    # the same weights in this process: the single-engine ground truth
    args = build_arg_parser().parse_args([*MODEL, *GEOM, "--device", "cpu"])
    eng = DecodeEngine(build_worker_model(args), device="cpu", num_slots=4,
                       max_length=64, page_size=16)
    want = [eng.submit(router._requests[r].prompt, router._requests[r].params)
            for r in rids]
    eng.run()
    for r, w in zip(rids, want):
        assert router.result(r).tolist() == eng.result(w).tolist()


def test_worker_asked_for_cuda_without_a_card_exits_non_zero():
    # no card visible to the child, whatever this machine holds
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
         "--master", f"127.0.0.1:{free_port()}", *MODEL],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
