"""The port's launcher, heartbeat watchdog and ``fleet.elastic`` against
the reference's (``paddle_tpu/distributed/launch``,
``paddle_tpu/runtime/watchdog.py``, ``paddle_tpu/distributed/fleet/
elastic.py``), after the reference's ``tests/test_elastic_relaunch.py``,
``test_launch_rendezvous.py`` and ``test_crash_safety.py``.

The launcher starts ``--nproc_per_node`` ranks a host and supervises them
as one group: a failed rank takes its siblings down and the group
relaunches, resuming from the newest whole checkpoint by the reference's
rule (the step after the newest committed save). Every subprocess runs
under its own timeout.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from conftest import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
TIMEOUT = 180


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("PADDLE_MASTER", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_CHAOS", "PADDLE_HEARTBEAT_INTERVAL"):
        env.pop(k, None)
    env.update(kw)
    return env


# -- the CLI -----------------------------------------------------------------
def test_parser_options_and_defaults_equal_the_references(monkeypatch):
    from paddle_tpu.distributed.launch import build_parser as ref_parser

    from paddle_tpu_torch.distributed.launch import build_parser

    for k in ("PADDLE_ELASTIC_MAX_RESTARTS", "PADDLE_RDZV_TIMEOUT",
              "PADDLE_HEARTBEAT_INTERVAL"):
        monkeypatch.delenv(k, raising=False)

    def options(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.type) for a in p._actions}

    assert options(build_parser()) == options(ref_parser())
    monkeypatch.setenv("PADDLE_ELASTIC_MAX_RESTARTS", "4")
    monkeypatch.setenv("PADDLE_HEARTBEAT_INTERVAL", "2.5")
    args = build_parser().parse_args(["x.py", "--lr", "1"])
    assert (args.max_restarts, args.heartbeat_interval) == (4, 2.5)
    assert args.training_script_args == ["--lr", "1"]


NEGOTIATE = textwrap.dedent("""
    import sys
    from paddle_tpu_torch.distributed.launch import negotiate_rank
    rank, store = negotiate_rank(sys.argv[1], 2, timeout=60)
    print("rank", rank, flush=True)
""")


def test_negotiate_rank_in_two_processes(tmp_path):
    script = tmp_path / "neg.py"
    script.write_text(NEGOTIATE)
    master = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), master],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-800:] for o in outs]
    ranks = sorted(int(o[0].split()[-1]) for o in outs)
    assert ranks == [0, 1]


def test_clean_exit_no_restart(tmp_path):
    script = tmp_path / "ok.py"
    script.write_text("import os\nprint('fine', os.environ["
                      "'PADDLE_TRAINER_ID'], os.environ['PADDLE_TRAINERS_NUM']"
                      ", os.environ['PADDLE_LOCAL_RANK'])\n")
    p = subprocess.run(LAUNCH + ["--nproc_per_node", "2", "--max_restarts",
                                 "3", str(script)], env=_env(),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "relaunching" not in p.stderr
    assert sorted(p.stdout.split("\n")[:2]) == ["fine 0 2 0", "fine 1 2 1"]


def test_restart_budget_exhausted_propagates_rc(tmp_path):
    script = tmp_path / "always_die.py"
    script.write_text("import os\nos._exit(9)\n")
    p = subprocess.run(LAUNCH + ["--max_restarts", "1", "--restart_backoff",
                                 "0.05", str(script)], env=_env(),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 9
    assert "relaunching (1/1)" in p.stderr
    assert "budget (1) exhausted" in p.stderr


def test_operator_kill_stops_job_without_relaunch(tmp_path):
    """SIGTERM to the launcher reaches every rank and ends the job (no
    relaunch of a deliberately killed group), exit 128 + SIGTERM."""
    script = tmp_path / "sleeper.py"
    script.write_text(
        "import os, pathlib, time\n"
        f"pathlib.Path({str(tmp_path)!r}, 'ready' + "
        "os.environ['PADDLE_TRAINER_ID']).touch()\ntime.sleep(120)\n")
    p = subprocess.Popen(LAUNCH + ["--nproc_per_node", "2", "--max_restarts",
                                   "3", str(script)], env=_env(),
                         stderr=subprocess.PIPE, text=True)
    ready = [tmp_path / f"ready{r}" for r in range(2)]
    deadline = time.monotonic() + 90
    while not all(r.exists() for r in ready) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(r.exists() for r in ready), "the ranks never started"
    t0 = time.monotonic()
    p.send_signal(signal.SIGTERM)
    rc = p.wait(timeout=60)
    stderr = p.stderr.read()
    assert rc == 128 + signal.SIGTERM, (rc, stderr[-500:])
    assert "relaunching" not in stderr
    assert time.monotonic() - t0 < 30  # the sleepers did not run out


TRAIN = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist, nn
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.runtime import watchdog
    from paddle_tpu_torch.testing import chaos

    work, total = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    dist.init_parallel_env()
    rank = dist.get_rank()
    torch.manual_seed(0)
    model = nn.Linear(4, 4)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    elastic = ElasticManager(os.path.join(work, "ckpt"), save_interval=2,
                             max_to_keep=5)
    start = elastic.resume(model, opt)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((8, 4)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((8, 4)), dtype=torch.float32)
    losses = []
    for step in range(start, total):
        if rank == 1:
            chaos.step_fence(step)  # PADDLE_CHAOS_KILL_STEP: kill -9 here
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        for p in model.parameters():  # the data-parallel mean of 2 ranks
            dist.all_reduce(p.grad)
            p.grad /= 2
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        elastic.maybe_save(step, model, opt)
    wd = watchdog.active()
    with open(os.path.join(work, f"done{rank}.json"), "w") as f:
        json.dump({"restart": int(os.environ["PADDLE_RESTART_COUNT"]),
                   "resumed_from": start, "losses": losses,
                   "weight": model.weight.detach().tolist(),
                   "bias": model.bias.detach().tolist(),
                   "watchdog": wd is not None and wd.beats > 0,
                   "stalled": wd.stalled if wd is not None else None}, f)
    dist.destroy_process_group()
""")


def test_kill_and_resume_through_the_launcher(tmp_path):
    """Rank 1 of 2 is SIGKILLed at step 7's fence: the launcher tears rank
    0 down, relaunches both, and they resume at step 6 (saves at steps 1,
    3, 5: the reference's rule, the step after the newest committed save)
    and end bit-equal to an uninterrupted run of the same math."""
    script = tmp_path / "train.py"
    script.write_text(TRAIN)
    total = 10
    env = _env(PADDLE_CHAOS="1", PADDLE_CHAOS_KILL_STEP="7")
    p = subprocess.run(LAUNCH + ["--nproc_per_node", "2", "--max_restarts",
                                 "2", "--restart_backoff", "0.1",
                                 "--heartbeat_interval", "1", str(script),
                                 str(tmp_path), str(total)],
                       env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "relaunching (1/2)" in p.stderr
    assert "rc=-9" in p.stderr or "rc=137" in p.stderr
    done = [json.loads((tmp_path / f"done{r}.json").read_text())
            for r in range(2)]
    for d in done:
        assert d["restart"] == 1
        assert d["resumed_from"] == 6
        assert d["watchdog"] and not d["stalled"]
    assert done[0]["weight"] == done[1]["weight"]
    # the uninterrupted run, in this process (two ranks' equal gradients
    # averaged are the gradient itself)
    from paddle_tpu_torch import nn, optimizer

    torch.manual_seed(0)
    model = nn.Linear(4, 4, device="cpu")
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((8, 4)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((8, 4)), dtype=torch.float32)
    losses = []
    for _ in range(total):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert done[0]["losses"] == losses[6:]
    assert done[0]["weight"] == model.weight.detach().tolist()
    assert done[0]["bias"] == model.bias.detach().tolist()


# -- ElasticManager ------------------------------------------------------------
def _model(seed=0):
    from paddle_tpu_torch import nn, optimizer

    torch.manual_seed(seed)
    m = nn.Sequential(nn.Linear(4, 8, device="cpu"), nn.ReLU(),
                      nn.Linear(8, 2, device="cpu"))
    opt = optimizer.AdamW(learning_rate=0.1, parameters=m.parameters())
    return m, opt


def _train(m, opt, steps=1):
    for _ in range(steps):
        m(torch.ones(3, 4)).square().mean().backward()
        opt.step()
        opt.clear_grad()


def _params(m):
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def _saved_run(tmp_path, steps=(1, 3), **kw):
    """A manager that saved after each of ``steps`` (training to it), and
    the parameters at each save."""
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    m, opt = _model()
    mgr = ElasticManager(str(tmp_path / "ckpt"), save_interval=1, **kw)
    at, done = {}, -1
    for s in steps:
        _train(m, opt, s - done)
        done = s
        mgr.save(s, m, opt)
        at[s] = _params(m)
    return mgr, at


def test_resume_skips_torn_and_falls_back_past_corrupt(tmp_path):
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.testing import chaos

    mgr, at = _saved_run(tmp_path, steps=(1, 3, 5))
    chaos.tear_checkpoint(os.path.join(mgr.ckpt_dir, "step_5"))
    chaos.corrupt_checkpoint(os.path.join(mgr.ckpt_dir, "step_3"))
    assert mgr.latest_step() == 3  # the torn one is not complete
    m2, opt2 = _model(seed=9)
    assert ElasticManager(mgr.ckpt_dir).resume(m2, opt2) == 2
    got = _params(m2)
    assert all(torch.equal(got[k], at[1][k]) for k in got)
    chaos.corrupt_checkpoint(os.path.join(mgr.ckpt_dir, "step_1"))
    with pytest.raises(RuntimeError, match="refusing"):
        ElasticManager(mgr.ckpt_dir).resume(m2, opt2)
    empty = ElasticManager(str(tmp_path / "fresh"))
    assert empty.resume(m2, opt2) == 0


def test_retention_keeps_the_newest(tmp_path):
    mgr, _ = _saved_run(tmp_path / "a", steps=(1, 3, 5, 7), max_to_keep=2)
    assert sorted(mgr._complete_steps()) == [5, 7]
    mgr0, _ = _saved_run(tmp_path / "b", steps=(1, 3), max_to_keep=0)
    assert sorted(mgr0._complete_steps()) == [3]


def test_async_save_commits_on_flush(tmp_path):
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    m, opt = _model()
    _train(m, opt)
    mgr = ElasticManager(str(tmp_path / "ckpt"), save_interval=2,
                         async_save=True)
    assert not mgr.maybe_save(0, m, opt)
    assert mgr.maybe_save(1, m, opt)
    want = _params(m)
    _train(m, opt, 2)  # the live weights move while the writer runs
    mgr.flush()
    assert mgr.latest_step() == 1
    m2, opt2 = _model(seed=5)
    assert ElasticManager(mgr.ckpt_dir).resume(m2, opt2) == 2
    got = _params(m2)
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert not any(".ptsave-tmp" in n for n in os.listdir(mgr.ckpt_dir))


def test_extra_sidecar_round_trips(tmp_path):
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    m, opt = _model()
    mgr = ElasticManager(str(tmp_path / "ckpt"), save_interval=1)
    rng_state = np.arange(5, dtype=np.int64)
    mgr.save(3, m, opt, extra={"rng": rng_state, "epoch": 2})
    m2, opt2 = _model(seed=1)
    extras = {}
    assert ElasticManager(mgr.ckpt_dir).resume(m2, opt2,
                                               extra_out=extras) == 4
    np.testing.assert_array_equal(np.asarray(extras["rng"]), rng_state)
    assert int(extras["epoch"]) == 2
    assert all(torch.equal(a, b) for a, b in zip(_params(m2).values(),
                                                 _params(m).values()))


def test_canonical_state_is_the_references():
    """The snapshot ``ElasticManager`` writes: the same keys as the
    reference's ``ElasticManager`` on the same GPT weights after one
    AdamW step on the same batch, the same values within the step's
    float noise."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.elastic import (
        ElasticManager as RefManager)
    from paddle_tpu.framework.op import raw
    from paddle_tpu.jit import TrainStep as RefTrainStep

    from paddle_tpu_torch import optimizer as toptim
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.jit import TrainStep

    from test_torch_fleet import _assert_params_close
    from torch_port_utils import (VOCAB, jax_tiny_gpt, numpy_state,
                                  torch_tiny_gpt)

    ids = np.random.default_rng(0).integers(0, VOCAB, (2, 16))
    with jax_tiny_gpt() as ref:
        state = numpy_state(ref)
        ref.train()
        ropt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                      parameters=ref.parameters())
        RefTrainStep(ref, lambda m, i: m(i, labels=i), ropt)(
            paddle.to_tensor(ids))
        want = RefManager.__new__(RefManager)._state(ref, ropt)
        want = {k: np.asarray(raw(v)) for k, v in want.items()}
    tm = torch_tiny_gpt(state)
    topt = toptim.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    TrainStep(tm, lambda m, i: m(i, labels=i), topt)(torch.as_tensor(ids))
    got = ElasticManager.__new__(ElasticManager)._state(tm, topt)
    got = {k: v.detach().numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    assert any(k.startswith("__opt__.") for k in got)
    _assert_params_close(got, want)


def test_live_resize_copies_and_falls_back_to_disk(tmp_path):
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    mgr, at = _saved_run(tmp_path, steps=(1,))
    m, opt = _model(seed=3)
    _train(m, opt, 2)
    src = mgr.capture(m, opt)
    m2, opt2 = _model(seed=4)
    assert mgr.live_resize(6, src, m2, opt2) == 7
    got, want = _params(m2), _params(m)
    assert all(torch.equal(got[k], want[k]) for k in got)
    # a source that cannot host the state: the newest checkpoint instead
    collective.reset_counts()
    bad = {k: v for k, v in src.items() if not k.startswith("0.")}
    assert mgr.live_resize(6, bad, m2, opt2) == 2
    assert collective.counts["reshard_fallback_disk_restore"] == 1
    got = _params(m2)
    assert all(torch.equal(got[k], at[1][k]) for k in got)


def test_stage_shard_helpers(tmp_path):
    from paddle_tpu_torch.distributed.fleet import elastic
    from paddle_tpu_torch.testing import chaos

    base = str(tmp_path)
    for stage, steps in ((0, (1, 2, 3)), (1, (1, 2))):
        for s in steps:
            elastic.save_stage_shard(base, stage, s, {
                "w": torch.full((2, 3), float(10 * stage + s))})
    assert elastic.latest_stage_step(base, 0) == 3
    assert elastic.latest_stage_step(base, 2) is None
    assert elastic.latest_common_step(base, 2) == 2
    assert elastic.latest_common_step(base, 3) is None
    chaos.tear_checkpoint(elastic.stage_shard_dir(base, 1, 2))
    assert elastic.latest_common_step(base, 2) == 1
    got = elastic.load_stage_shard(base, 0, 3)
    assert torch.equal(got["w"], torch.full((2, 3), 3.0))
    moved = elastic.stage_live_resize(0, {"w": got["w"], "k": 1},
                                      {"w": torch.device("cpu")})
    assert torch.equal(moved["w"], got["w"]) and moved["k"] == 1


def test_resize_signals_over_the_store():
    from paddle_tpu_torch.distributed.fleet import elastic
    from paddle_tpu_torch.runtime import TCPStore

    store = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=10)
    assert elastic.poll_resize(store) is None
    elastic.request_resize(store, 6)
    assert elastic.poll_resize(store) == 6
    assert elastic.poll_resize(store) == 6  # stays until cleared
    elastic.clear_resize(store)
    assert elastic.poll_resize(store) is None
    assert elastic.poll_stage_resize(store) is None
    elastic.request_stage_resize(store, 1, 3)
    assert elastic.poll_stage_resize(store) == (1, 3)
    elastic.clear_stage_resize(store)
    assert elastic.poll_stage_resize(store) is None
    store.close()


COMMIT_KILL = textwrap.dedent("""
    import sys
    import torch
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    torch.manual_seed(0)
    m = nn.Linear(4, 4, device="cpu")
    opt = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    mgr = ElasticManager(sys.argv[1], save_interval=2)
    for step in range(6):
        m(torch.ones(2, 4)).square().mean().backward()
        opt.step()
        opt.clear_grad()
        mgr.maybe_save(step, m, opt)  # step 3's commit is killed
        if step == 1:
            torch.save(m.state_dict(), sys.argv[1] + ".at1")
    print("survived", flush=True)
""")


def test_kill_at_commit_leaves_the_previous_checkpoint(tmp_path):
    """``chaos.on_commit`` (PADDLE_CHAOS_CKPT_MODE=crash) kills the writer
    between step 3's body and its commit: only ``step_1`` is a checkpoint,
    and ``ElasticManager.resume`` restores it."""
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    script = tmp_path / "commit.py"
    script.write_text(COMMIT_KILL)
    ckpt = tmp_path / "ckpt"
    p = subprocess.run([sys.executable, str(script), str(ckpt)],
                       env=_env(PADDLE_CHAOS="1",
                                PADDLE_CHAOS_CKPT_MODE="crash",
                                PADDLE_CHAOS_CKPT_STEP="3"),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    assert "survived" not in p.stdout
    names = sorted(os.listdir(ckpt))
    assert "step_1" in names and "step_3" not in names
    assert "step_3.ptsave-tmp" in names
    from paddle_tpu_torch import nn, optimizer

    torch.manual_seed(7)
    m = nn.Linear(4, 4, device="cpu")
    opt = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    assert ElasticManager(str(ckpt)).resume(m, opt) == 2
    want = torch.load(str(ckpt) + ".at1")
    assert all(torch.equal(v, want[k]) for k, v in m.state_dict().items())


# -- the watchdog ----------------------------------------------------------------
def _watchdog_pair(interval, miss, beat_peer):
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.runtime.watchdog import HeartbeatWatchdog

    port = free_port()
    store0 = TCPStore("127.0.0.1", port, is_master=True, timeout=10)
    store1 = TCPStore("127.0.0.1", port, is_master=False, timeout=10)
    fired = threading.Event()
    seen = {}

    def on_stall(stalled, grace):
        seen.update(stalled=dict(stalled), at=time.monotonic())
        fired.set()

    peer = None
    if beat_peer:
        peer = HeartbeatWatchdog(store1, 1, 2, interval=interval,
                                 miss=miss, label="t").start()
    t0 = time.monotonic()
    mon = HeartbeatWatchdog(store0, 0, 2, interval=interval, miss=miss,
                            label="t", on_stall=on_stall).start()
    return mon, peer, fired, seen, t0, (store0, store1)


def test_watchdog_fires_on_a_silent_peer():
    interval, miss = 0.2, 3
    mon, _, fired, seen, t0, stores = _watchdog_pair(interval, miss, False)
    assert fired.wait(timeout=interval * miss + 3.0)
    assert list(seen["stalled"]) == [1]
    assert seen["at"] - t0 <= interval * miss + 2 * interval + 1.0
    mon.stop()


def test_watchdog_stays_silent_while_the_peer_beats():
    interval, miss = 0.2, 3
    mon, peer, fired, _, _, stores = _watchdog_pair(interval, miss, True)
    assert not fired.wait(timeout=interval * miss * 3)
    assert peer.beats > 5 and not mon.stalled
    peer.stop()  # leaving on purpose is not a stall
    assert not fired.wait(timeout=interval * miss * 2)
    mon.stop()
