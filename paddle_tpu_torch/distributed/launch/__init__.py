"""Launch CLI (``python -m paddle_tpu_torch.distributed.launch``),
counterpart of ``paddle_tpu/distributed/launch/``.

The reference starts ONE JAX process per host, which drives every local
chip, and exports the JAX coordinator env. The port's ranks are processes
(one per card, as upstream Paddle and PyTorch run them), so this launcher
starts ``--nproc_per_node`` children per host, each with the env
``distributed.init_parallel_env`` reads, as ``distributed.spawn`` sets it:

  PADDLE_TRAINER_ID    global rank, ``node_rank * nproc_per_node + local``
  PADDLE_TRAINERS_NUM  ``nnodes * nproc_per_node``
  PADDLE_LOCAL_RANK    the child's index on this host (its CUDA device)
  PADDLE_MASTER        ``host:port`` of the process group's store (rank 0
                       binds it); on one host without ``--master`` a free
                       local port, chosen anew for each launch attempt
  PADDLE_RESTART_COUNT the launch attempt (0 first)

Multi-host jobs negotiate each host's ``node_rank`` through a
``runtime.TCPStore`` on the master's port + 1 (``negotiate_rank``), as the
reference does: torch's store holds the master port itself, as JAX's
coordinator does in the reference.

Supervision (``_supervise``) treats a host's children as one unit, since a
torch process group cannot take a replacement for one rank: a nonzero exit
of any child terminates its siblings, and the whole group relaunches
within ``--max_restarts`` after a backoff that doubles per retry (capped at
30 s), training resuming from the newest checkpoint
(``fleet.elastic.ElasticManager``). SIGTERM / SIGINT are forwarded to every
child and latched, so an operator's kill ends the job without a relaunch.
The exit code is the failed child's (128 + n for a death by signal n), or
128 + the signal of an operator's kill.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from ... import observability as _obs

__all__ = ["build_parser", "negotiate_rank", "launch"]

#: seconds a sibling gets to exit after SIGTERM before it is SIGKILLed
_TERM_GRACE = 10.0


def build_parser():
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=str, default="1", help="number of hosts")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes (ranks) started on this host, one "
                        "per card")
    p.add_argument("--master", type=str, default=None,
                   help="coordinator host:port")
    p.add_argument("--rank", type=int, default=None,
                   help="this host's node rank")
    p.add_argument("--ips", type=str, default=None,
                   help="comma-separated host ips (parity)")
    p.add_argument("--devices", "--gpus", "--xpus", type=str, default=None,
                   dest="devices")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--max_restarts", type=int,
                   default=int(os.environ.get("PADDLE_ELASTIC_MAX_RESTARTS",
                                              "0")),
                   help="bounded-retry relaunch count on nonzero worker exit "
                        "(reference: elastic controllers' restart budget)")
    p.add_argument("--restart_backoff", type=float, default=1.0,
                   help="base seconds between relaunches (doubles per retry, "
                        "capped)")
    p.add_argument("--rdzv_timeout", type=float,
                   default=float(os.environ.get("PADDLE_RDZV_TIMEOUT", "300")),
                   help="seconds to wait for all hosts at the rank-negotiation "
                        "rendezvous before failing with a diagnosis")
    p.add_argument("--heartbeat_interval", type=float,
                   default=float(os.environ.get("PADDLE_HEARTBEAT_INTERVAL",
                                                "0")),
                   help="seconds between liveness beats; >0 arms the "
                        "hung-rank watchdog in every worker "
                        "(PADDLE_HEARTBEAT_MISS beats of silence fail the job "
                        "loudly). 0 disables.")
    p.add_argument("--serving_master", type=str, default=None,
                   help="host:port of a serving coordination store; exported "
                        "as PADDLE_SERVING_MASTER so a supervised "
                        "serving.worker registers there (a relaunch after "
                        "--max_restarts joins as a FRESH engine index; the "
                        "router fails over the dead one's work meanwhile)")
    p.add_argument("--mpmd_stages", type=str, default=None,
                   help="comma-separated per-stage widths for the MPMD "
                        "pipeline (e.g. '3,1'); exported as "
                        "PADDLE_TPU_MPMD_STAGES so distributed.mpmd."
                        "MpmdPipeline picks the stage widths up without a "
                        "script change, and a relaunch after a stage failure "
                        "re-enters with the SAME stage layout")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p


def negotiate_rank(master: str, nnodes: int, timeout: float = 300.0):
    """Negotiate this host's node rank through the TCPStore at ``master``.

    The host that binds the port becomes node 0 and runs the store server;
    every other host draws the next id from a shared counter. Returns
    ``(rank, store)``."""
    from ...runtime import TCPStore

    host, port = master.rsplit(":", 1)
    try:
        store = TCPStore(host=host, port=int(port), is_master=True,
                         timeout=5.0)
        rank = 0
    except (ConnectionError, OSError):
        store = TCPStore(host=host, port=int(port), is_master=False,
                         timeout=timeout)
        rank = store.add("__launch/rank_counter", 1)
    if rank >= nnodes:
        store.close()
        raise RuntimeError(
            f"negotiate_rank: {rank + 1} processes joined a {nnodes}-node job "
            f"at {master}: stale store or wrong --nnodes")
    # master-closes-last rendezvous (a symmetric counter barrier is racy:
    # the master's exit takes the store server down)
    store.asymmetric_handshake("__launch", rank, nnodes, timeout)
    return rank, store


def _port_free(port: int) -> bool:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def _free_master() -> str:
    """``127.0.0.1:p`` with p (the process group's store) and p + 2 (the
    heartbeat store) free."""
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port + 2 < 65536 and _port_free(port + 2):
            return f"127.0.0.1:{port}"
    raise RuntimeError("launch: no free local port pair for the master")


def _stop_group(children, sig=signal.SIGTERM):
    """Signal every live child, wait ``_TERM_GRACE``, then SIGKILL."""
    for c in children:
        if c.poll() is None:
            c.send_signal(sig)
    deadline = time.monotonic() + _TERM_GRACE
    for c in children:
        try:
            c.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            c.kill()
            c.wait()


def _wait_group(children, stop) -> int:
    """Wait for the group: 0 once every child exited 0; at the first
    nonzero exit the siblings are terminated and that code returned."""
    while True:
        if stop:
            for c in children:
                c.wait()
            return 0
        done = True
        for c in children:
            rc = c.poll()
            if rc is None:
                done = False
            elif rc != 0:
                _stop_group([s for s in children if s is not c])
                return rc
        if done:
            return 0
        time.sleep(0.05)


def _supervise(cmd, env, max_restarts: int, backoff: float,
               nproc: int = 1, node_rank: int = 0, nnodes: int = 1,
               fixed_master: bool = True) -> int:
    """Start the host's ``nproc`` children, watch them as one group, and
    relaunch the group on a nonzero exit with bounded retries (the
    reference launch controllers' watch loop). SIGTERM / SIGINT are
    forwarded to every child AND latched: an operator's kill tears the
    job down instead of restarting it."""
    attempt = 0
    children = []
    stop: dict = {}

    def forward(signum, frame):
        stop["sig"] = signum
        for c in children:
            if c.poll() is None:
                c.send_signal(signum)

    old_term = signal.signal(signal.SIGTERM, forward)
    old_int = signal.signal(signal.SIGINT, forward)
    try:
        while True:
            if not fixed_master:
                env["PADDLE_MASTER"] = _free_master()
            env["PADDLE_RESTART_COUNT"] = str(attempt)
            children = []
            for local in range(nproc):
                child_env = dict(env)
                child_env["PADDLE_TRAINER_ID"] = str(node_rank * nproc
                                                     + local)
                child_env["PADDLE_LOCAL_RANK"] = str(local)
                child_env["PADDLE_TRAINERS_NUM"] = str(nnodes * nproc)
                children.append(subprocess.Popen(cmd, env=child_env))
            if stop:
                # a kill latched between the handler's installation (or
                # the backoff check) and Popen would otherwise leave these
                # workers running to completion
                for c in children:
                    c.send_signal(stop["sig"])
            rc = _wait_group(children, stop)
            if stop:
                return 128 + stop["sig"]
            if rc == 0:
                return 0
            if attempt >= max_restarts:
                if max_restarts:
                    print(f"[launch] worker exited rc={rc}; restart budget "
                          f"({max_restarts}) exhausted", file=sys.stderr)
                # the conventional status of a death by signal (137 for
                # SIGKILL), not python's 256 + rc wraparound
                return 128 - rc if rc < 0 else rc
            attempt += 1
            delay = min(backoff * (2 ** (attempt - 1)), 30.0)
            _obs.inc("elastic_relaunch_total")
            _obs.event("worker_relaunch", rc=rc, attempt=attempt,
                       max_restarts=max_restarts, backoff=round(delay, 3))
            print(f"[launch] worker exited rc={rc}; relaunching "
                  f"({attempt}/{max_restarts}) in {delay:.1f}s: training "
                  "should resume from the latest checkpoint "
                  "(fleet.elastic.ElasticManager)", file=sys.stderr,
                  flush=True)
            # interruptible backoff: a kill during the wait stops the job
            deadline = time.monotonic() + delay
            while not stop and time.monotonic() < deadline:
                time.sleep(min(0.2, max(0.0, deadline - time.monotonic())))
            if stop:
                return 128 + stop["sig"]
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def launch(argv=None):
    args = build_parser().parse_args(argv)
    nnodes = int(str(args.nnodes).split(":")[0])
    nproc = max(1, int(args.nproc_per_node))
    node_rank = 0
    if nnodes > 1:
        if not args.master:
            raise SystemExit("--master host:port is required for multi-host "
                             "launch")
        if args.rank is not None:
            node_rank = args.rank
        elif "PADDLE_NODE_RANK" in os.environ:
            node_rank = int(os.environ["PADDLE_NODE_RANK"])
        else:
            # negotiate on master_port + 1: the master port belongs to the
            # process group's store that rank 0 binds in
            # init_parallel_env. The negotiation store closes before the
            # workers start: the asymmetric handshake guarantees no
            # client has a request outstanding by then
            host, port = args.master.rsplit(":", 1)
            try:
                node_rank, _store = negotiate_rank(
                    f"{host}:{int(port) + 1}", nnodes,
                    timeout=args.rdzv_timeout)
            except TimeoutError as e:
                raise SystemExit(
                    f"[launch] rendezvous failed after "
                    f"{args.rdzv_timeout:.0f}s: {e}\n[launch] every host must "
                    f"run the same launch command with --nnodes={nnodes} and "
                    f"--master={args.master} (raise PADDLE_RDZV_TIMEOUT / "
                    "--rdzv_timeout for slow cluster starts)") from e
            _store.close()
        os.environ["PADDLE_NODE_RANK"] = str(node_rank)
    if args.master:
        os.environ["PADDLE_MASTER"] = args.master
    if args.heartbeat_interval > 0:
        # the workers read these in init_parallel_env (runtime.watchdog)
        os.environ["PADDLE_HEARTBEAT_INTERVAL"] = str(args.heartbeat_interval)
        os.environ.setdefault("PADDLE_HEARTBEAT_MISS", "5")
    if args.serving_master:
        # serving.worker's --master defaults to this env var
        os.environ["PADDLE_SERVING_MASTER"] = args.serving_master
    if args.mpmd_stages:
        # validated here so a typo fails the LAUNCH, not the Nth relaunch
        try:
            widths = [int(w) for w in args.mpmd_stages.split(",")
                      if w.strip()]
        except ValueError:
            widths = []
        if not widths or any(w < 1 for w in widths):
            raise SystemExit(
                f"--mpmd_stages={args.mpmd_stages!r}: want comma-separated "
                "positive per-stage widths, e.g. '2,2' or '3,1'")
        os.environ["PADDLE_TPU_MPMD_STAGES"] = ",".join(str(w)
                                                        for w in widths)
    cmd = [sys.executable, args.training_script] + list(
        args.training_script_args)
    env = os.environ.copy()
    # the workers are fresh interpreters: propagate the launcher's import
    # path, so an uninstalled checkout stays importable in the children
    inherited = [p for p in sys.path if p]
    if env.get("PYTHONPATH"):
        inherited.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(inherited)
    rc = _supervise(cmd, env, args.max_restarts, args.restart_backoff,
                    nproc=nproc, node_rank=node_rank, nnodes=nnodes,
                    fixed_master=bool(args.master) or nproc * nnodes == 1)
    if rc:
        sys.exit(rc)
