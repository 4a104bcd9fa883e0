"""Registered metric names and event kinds — the telemetry vocabulary
(counterpart of ``paddle_tpu/observability/catalog.py``: the same names,
kinds and help texts, so a dashboard built on the reference reads the
port's exports; span owners name the port's files).

Every metric recorded by the port MUST be declared here (literal names
only, the kind matching the recording call). The point is grep-ability: an operator reading a dashboard can find every
call site of a metric by its registered name, and two subsystems cannot
accidentally export the same name with different meanings.

Naming convention:
  * lowercase snake_case (``metrics.NAME_RE``);
  * counters end in ``_total`` (or ``_bytes_total`` for byte counts);
  * histograms/gauges carry their unit as a suffix (``_seconds``,
    ``_bytes``);
  * the exporter prefixes everything with ``paddle_tpu_`` — names here are
    unprefixed.

This module stays dependency-free (stdlib only, no package imports), so
it loads straight from its file path.
"""

#: name -> (kind, help). Kind is one of counter | gauge | histogram.
METRICS = {
    # -- XLA compilation (jit cache misses) ---------------------------------
    "xla_compile_total": (
        "counter",
        "XLA compilations = jit cache misses (labels: where)"),
    "xla_compile_seconds": (
        "histogram",
        "Wall time of each cache-miss step: trace + compile + first run"),
    # -- training loop ------------------------------------------------------
    "train_step_seconds": (
        "histogram", "Per-step wall time measured at the train-step dispatch"),
    "train_tokens_per_second": (
        "gauge", "Input elements consumed per second (last step)"),
    "train_flops_per_second": (
        "gauge", "Achieved FLOP/s from XLA cost analysis (last step)"),
    "train_mfu": (
        "gauge",
        "Estimated model FLOPs utilization vs PADDLE_TPU_PEAK_FLOPS"),
    # -- checkpointing ------------------------------------------------------
    "checkpoint_save_seconds": (
        "histogram", "Checkpoint save wall time, body write through commit"),
    "checkpoint_save_bytes_total": (
        "counter", "Total bytes committed to checkpoints"),
    "checkpoint_restore_seconds": (
        "histogram", "Checkpoint restore wall time"),
    # -- coordination store -------------------------------------------------
    "store_op_seconds": (
        "histogram", "py_store client op latency (labels: op)"),
    "store_op_retry_total": (
        "counter", "Idempotent store ops re-issued after a dropped "
                   "connection (labels: op)"),
    "store_reconnect_total": (
        "counter", "Client store reconnects (backoff dials)"),
    "store_connect_attempts_total": (
        "counter", "Failed store connect attempts during backoff"),
    # -- watchdog / liveness ------------------------------------------------
    "heartbeat_age_seconds": (
        "gauge", "Seconds since a rank's heartbeat last advanced "
                 "(labels: rank)"),
    "watchdog_poll_age_seconds": (
        "histogram", "Observed heartbeat ages per watchdog poll "
                     "(labels: rank)"),
    "heartbeat_beats_total": (
        "counter", "Heartbeats published by this rank"),
    # -- elastic / relaunch -------------------------------------------------
    "elastic_relaunch_total": (
        "counter", "Worker relaunches by the launch supervisor"),
    "elastic_resume_total": (
        "counter", "Successful ElasticManager.resume restores"),
    "elastic_resume_fallback_total": (
        "counter", "Checkpoints skipped during resume (torn/corrupt/failed)"),
    # -- gradient communication (distributed/grad_comm.py) ------------------
    "grad_comm_bytes_total": (
        "counter", "Gradient-exchange payload bytes at the wire dtype, "
                   "accumulated per executed step"),
    "grad_comm_buckets": (
        "gauge", "Fusion buckets in the compiled gradient exchange "
                 "(one collective each; 0/absent = unbucketed GSPMD path)"),
    "grad_comm_quantized_fraction": (
        "gauge", "Fraction of f32 gradient bytes removed by the reduced-"
                 "precision wire (0.0 = f32, 0.5 = bf16, 0.75 = int8)"),
    "grad_comm_overlap_ratio": (
        "gauge", "Share of exchanged bytes outside the last-issued bucket "
                 "— the part that can overlap remaining backward compute"),
    # -- mp activation communication (distributed/mp_comm.py) ---------------
    "mp_comm_sites_total": (
        "counter", "Quantized mp recombination sites traced (one per "
                   "row/column/embedding/logit wire build)"),
    "mp_comm_wire_bytes_total": (
        "counter", "Per-device wire bytes the traced mp recombinations "
                   "move at the wire dtype (payload + f32 scales)"),
    "mp_comm_quantized_fraction": (
        "gauge", "Fraction of f32 mp-activation bytes removed by the "
                 "reduced-precision wire across all traced sites"),
    # -- pipeline schedules (fleet/meta_parallel/pipeline_parallel.py) ------
    "pp_bubble_fraction": (
        "gauge", "Idle-cell fraction of the compiled pipeline schedule "
                 "table (fwd + bwd tick grids; smaller = better overlap)"),
    "pp_schedule_ticks": (
        "gauge", "Total (stage, tick) grid length of the compiled pipeline "
                 "schedule (fwd + bwd; zero_bubble adds its deferred "
                 "weight-grad scan)"),
    "pp_overlap_hidden_bytes": (
        "gauge", "Wire bytes of bucketed pipeline-region gradient "
                 "collectives issued before the last bucket — comm the "
                 "backward can hide (0 = monolithic or unbucketed)"),
    # -- serving decode engine (inference/engine.py) ------------------------
    "serving_requests_total": (
        "counter", "Requests submitted to the decode engine"),
    "serving_tokens_total": (
        "counter", "Tokens generated by the decode engine (prefill first "
                   "tokens + decode steps)"),
    "serving_ttft_seconds": (
        "histogram", "Time to first token: submit() through the prefill "
                     "that produced the request's first generated token"),
    "serving_decode_step_seconds": (
        "histogram", "Wall time of one batched decode step (all occupied "
                     "slots advance one token)"),
    "serving_tokens_per_second": (
        "gauge", "Generated tokens per second over the last run() drain"),
    "serving_queue_depth": (
        "gauge", "Requests waiting for a free slot"),
    "serving_batch_occupancy": (
        "gauge", "Occupied decode slots / num_slots (0..1)"),
    "serving_kv_cache_utilization": (
        "gauge", "Mean fraction of each occupied slot's KV ring actually "
                 "holding tokens (0..1)"),
    "serving_engine_compile_total": (
        "counter", "Engine program compilations: one per prompt bucket "
                   "prefill + one decode + one verify program (labels via "
                   "signature)"),
    "serving_kv_pages_free": (
        "gauge", "KV pages on the paged pool's free list (trash page 0 "
                 "excluded)"),
    "serving_kv_pages_shared": (
        "gauge", "KV pages referenced by more than one owner — prefix-"
                 "cache sharing in effect"),
    "serving_prefix_hit_tokens": (
        "counter", "Prompt tokens served from the prefix-cache registry "
                   "instead of being prefilled"),
    "serving_spec_accept_ratio": (
        "gauge", "Accepted / proposed draft tokens of speculative decode "
                 "since engine start (0..1)"),
    "serving_logit_wire_bytes": (
        "gauge", "Per-device wire bytes of one sharded-decode logit "
                 "recombination at the configured logit wire (f32 = the "
                 "exact all-gather; int8 adds scales + exact-argmax "
                 "verify sidecar)"),
    "serving_admission_wait_seconds": (
        "histogram", "Bounded-backoff sleep taken when waiting requests "
                     "cannot be admitted (no free slot/pages) — replaces "
                     "the old hot-spin; each observation is one backoff"),
    # -- attention kernel plane (inference/engine.py, docs/SERVING.md
    #    §kernel plane; single-writer: the engine owns the resolution) ------
    "attn_kernel_active": (
        "gauge", "1.0 when the fused Pallas paged-attention kernel serves "
                 "the engine's compiled programs, 0.0 on the einsum "
                 "reference oracle (PADDLE_TPU_ATTN_KERNEL / "
                 "EngineConfig.attn_kernel)"),
    "attn_kernel_fused_dequant_bytes_total": (
        "counter", "f32 bytes NEVER materialized because int8 KV dequant "
                   "ran fused inside the Pallas kernel instead of as a "
                   "per-layer pool pass (2 pools × layers × pool bytes "
                   "per decode/verify step)"),
    "attn_kernel_fallback_total": (
        "counter", "Engine resolutions that asked for the Pallas kernel "
                   "but fell back to the einsum oracle (mp-sharded pool, "
                   "or pallas TPU support missing)"),
    # -- serving router (serving/router.py) ---------------------------------
    "serving_router_requests_total": (
        "counter", "Requests submitted to the multi-engine router"),
    "serving_router_shed_total": (
        "counter", "Requests shed by SLO admission control (queue_full or "
                   "deadline) — never a silent drop"),
    "serving_router_dispatch_total": (
        "counter", "Requests dispatched to an engine worker (resubmits "
                   "after failover count again)"),
    "serving_router_failover_total": (
        "counter", "In-flight requests resubmitted because their engine's "
                   "occupancy beat went stale past the grace window"),
    "serving_router_affinity_hits_total": (
        "counter", "Dispatches routed by prefix affinity (a chain-hashed "
                   "prompt block previously served by that engine)"),
    "serving_router_queue_depth": (
        "gauge", "Admitted requests queued at the router across all SLO "
                 "classes (dispatched requests excluded)"),
    "serving_router_engines": (
        "gauge", "Live engines known to the router (beat fresh within the "
                 "grace window)"),
    "serving_router_request_seconds": (
        "histogram", "Router-side request latency: submit() through result "
                     "harvest (includes queueing, dispatch, decode)"),
    "serving_router_engine_outstanding_tokens": (
        "gauge", "Placement load signal per live engine: reported "
                 "outstanding tokens + dispatched-but-unacked work "
                 "(labels: engine)"),
    "serving_router_admission_queue_length": (
        "gauge", "Admitted-but-undispatched requests per SLO class queue "
                 "(labels: slo)"),
    # -- federated front tier (serving/frontier.py) --------------------------
    "frontier_requests_total": (
        "counter", "Requests submitted to the federated front tier "
                   "(before the quota gate and leaf placement)"),
    "frontier_quota_shed_total": (
        "counter", "Requests shed at the front tier because the tenant's "
                   "token bucket ran dry — attributed to the TENANT'S "
                   "ledger row, never to a leaf or the class error "
                   "budget"),
    "frontier_rebalance_total": (
        "counter", "Tenants newly promoted to the hot set (heavy-hitter "
                   "share past hot_tenant_share): their traffic fans out "
                   "over their top rendezvous leaves"),
    "frontier_leaves": (
        "gauge", "Leaf routers federated under the front tier"),
    "frontier_queue_depth": (
        "gauge", "Admitted-but-undispatched requests summed across every "
                 "leaf's SLO class queues"),
    # -- streaming dataplane (serving/transport.py) --------------------------
    "serving_transport_frames_total": (
        "counter", "Frames moved over the streaming router<->worker "
                   "transport (labels: dir=send|recv, kind=frame tag)"),
    "serving_transport_bytes_total": (
        "counter", "Encoded frame bytes on the streaming transport "
                   "(labels: dir; recv counts land via send on the peer)"),
    "serving_transport_reconnect_total": (
        "counter", "Transport client redials after a severed connection "
                   "(jittered-backoff reconnect path)"),
    "serving_transport_stream_seconds": (
        "histogram", "Wire latency of timestamped frames (occ heartbeats, "
                     "token-stream updates): send wall clock to receive "
                     "(wall-to-wall, subject to host clock skew)"),
    # -- resharding (distributed/reshard.py) --------------------------------
    "reshard_total": (
        "counter", "Completed reshard operations (labels: what = "
                   "restore|live|array)"),
    "reshard_fallback_total": (
        "counter", "Reshard degradations: host round-trip transfers or "
                   "live-resize falls back to disk restore (labels: why)"),
    "reshard_seconds": (
        "histogram", "Wall time of one reshard (plan + execute, all leaves)"),
    "reshard_plan_steps": (
        "histogram", "Planned collective steps per resharded leaf"),
    "reshard_peak_bytes": (
        "histogram", "Analytic peak per-device bytes of one leaf's plan "
                     "(max over steps of in+out local shard bytes); the "
                     "host-roundtrip fallback observes the host bytes it "
                     "actually materialized per shard callback instead, "
                     "so the planned bound is falsifiable"),
    "reshard_bytes_total": (
        "counter", "Bytes moved through reshard collectives (sum of "
                   "per-step output local bytes across devices)"),
    # -- auto-parallel planner (distributed/auto_parallel/planner.py) -------
    "autoplan_candidates": (
        "gauge", "Divisibility-legal layout candidates enumerated by the "
                 "last plan() call (before the memory prune)"),
    "autoplan_pruned_memory": (
        "gauge", "Candidates dropped by the analytic per-device memory "
                 "bound in the last plan() call"),
    "autoplan_predicted_step_seconds": (
        "gauge", "Cost-model step-time prediction for the layout the "
                 "planner chose"),
    "autoplan_plan_seconds": (
        "histogram", "Wall time of one plan() enumerate+score+rank pass"),
    "autoplan_applied_total": (
        "counter", "Auto-planned layouts merged into a DistributedStrategy "
                   "(manual knobs always win; labels: ndev)"),
    # -- persistent AOT compile cache (runtime/compile_cache.py) ------------
    "compile_cache_hits_total": (
        "counter", "Executables loaded from the persistent AOT compile "
                   "cache instead of recompiling (labels: where)"),
    "compile_cache_miss_total": (
        "counter", "Compile-cache lookups that fell through to a fresh "
                   "lowered.compile() (labels: where)"),
    "compile_cache_corrupt_total": (
        "counter", "Cache entries that failed to deserialize and were "
                   "evicted — always followed by a fresh compile, never "
                   "a crash (labels: where)"),
    "compile_cache_store_errors_total": (
        "counter", "Executables that could not be serialized/written to "
                   "the cache (non-fatal; labels: where)"),
    "compile_cache_bytes_total": (
        "counter", "Serialized executable bytes written to the persistent "
                   "cache"),
    "compile_cache_load_seconds": (
        "histogram", "Wall time to read+deserialize+load one cached "
                     "executable (the price of a hit)"),
    # -- MPMD pipeline execution (distributed/mpmd.py) ----------------------
    "mpmd_stage_compile_total": (
        "counter", "Per-stage MPMD program builds (labels: stage, "
                   "program = fwd|bwd|loss_grad, hit = compile-cache "
                   "outcome) — the stage-local-recompile gate reads this"),
    "mpmd_tick_total": (
        "counter", "Schedule-table ops executed by stage runners "
                   "(labels: stage, kind = F|B)"),
    "mpmd_boundary_bytes_total": (
        "counter", "Activation/cotangent bytes shipped over inter-stage "
                   "queues at the resolved wire dtype (labels: channel)"),
    "mpmd_queue_replay_total": (
        "counter", "Unacked boundary-frame tails replayed after a "
                   "reconnect (labels: channel)"),
    "mpmd_stage_idle_fraction": (
        "gauge", "1 - busy/wall per stage runner in the last step — the "
                 "bubble each stage actually saw (labels: stage)"),
    "mpmd_step_seconds": (
        "histogram", "Wall time of one MPMD train_batch (all stages, all "
                     "microbatches, grads scattered)"),
    # -- live telemetry plane (observability/live.py) ------------------------
    # Single-writer families: live_* and slo_* may only be recorded from
    # observability/live.py (static gate rule 5).
    "live_ship_batches_total": (
        "counter", "Telemetry payload batches collected by a LiveShipper "
                   "for the tele frame (before redundancy re-sends)"),
    "live_ship_spans_total": (
        "counter", "Span records tailed from the local sink and shipped "
                   "in tele payloads"),
    "live_ingest_total": (
        "counter", "Fresh tele payloads accepted by the LiveAggregator"),
    "live_ingest_dup_total": (
        "counter", "Tele payloads dropped as duplicates/stale by the "
                   "(source, seq) dedup — redundant beat re-sends and "
                   "retransmits collapsing as designed"),
    "live_health_writes_total": (
        "counter", "Atomic fleet_health.json writes by the aggregator"),
    "live_window_requests": (
        "gauge", "Completed requests inside the aggregator's sliding "
                 "window (labels: slo)"),
    "slo_burn_rate": (
        "gauge", "Windowed error-budget burn rate vs the declared "
                 "objective (labels: slo, objective=latency|availability; "
                 "1.0 = budget consumed exactly as fast as it accrues)"),
    # -- fleet supervisor (distributed/fleet/supervisor.py) ------------------
    # Single-writer family: supervisor_* may only be recorded from the
    # supervisor module (static gate), the way live_*/slo_* are owned.
    "supervisor_flips_total": (
        "counter", "Committed role flips executed by the fleet supervisor "
                   "(labels: direction = to_training|to_serving; "
                   "roll-forward recoveries count — the commit fence was "
                   "journaled)"),
    "supervisor_flip_duration_seconds": (
        "histogram", "Wall time of one committed flip transaction, plan "
                     "fence through finalize (drain wait included)"),
    "supervisor_rollbacks_total": (
        "counter", "Flip transactions rolled back — an executor failure "
                   "before the commit fence, or crash recovery of a "
                   "pre-commit journal"),
    "supervisor_fleet_roles": (
        "gauge", "Fleet inventory by role from the durable roles doc "
                 "(labels: role = serving|training)"),
    "supervisor_breaker_open": (
        "gauge", "1.0 while the flip-storm circuit breaker is open "
                 "(too many commits inside the breaker window; the "
                 "supervisor only observes until it cools)"),
    # -- per-tenant cost accounting (observability/accounting.py) -----------
    # Single-writer family: tenant_* may only be recorded from the
    # accounting module (static gate), the way live_*/slo_* are owned.
    # Gauges, not counters: they republish cumulative ledger totals, so
    # re-publishing is idempotent and never double-counts.
    "tenant_device_seconds": (
        "gauge", "Cumulative normalized device-seconds attributed to a "
                 "tenant by the metering ledger, priced via the planner "
                 "cost constants (labels: tenant)"),
    "tenant_tokens": (
        "gauge", "Cumulative tokens attributed to a tenant by the ledger "
                 "(labels: tenant, kind = prefill|decode|spec_accepted|"
                 "spec_wasted)"),
    "tenant_kv_page_seconds": (
        "gauge", "Cumulative time-integrated KV page occupancy attributed "
                 "to a tenant, shared-prefix pages split pro rata across "
                 "refholders (labels: tenant)"),
    "tenant_wire_bytes": (
        "gauge", "Cumulative logit/KV wire bytes attributed to a tenant "
                 "(labels: tenant)"),
    "tenant_shed_requests": (
        "gauge", "Cumulative requests shed by router admission control, "
                 "attributed to the tenant that sent them "
                 "(labels: tenant)"),
    "tenant_outstanding_tokens": (
        "gauge", "Outstanding tokens in flight per engine per tenant at "
                 "the router — the raw signal the per-tenant quota ladder "
                 "gates on (labels: engine, tenant)"),
    # -- online continuous learning (serving/online.py) ---------------------
    # Single-writer family: online_* may only be recorded from the
    # online weight-flip coordinator (static gate), like supervisor_*.
    "online_weight_epoch": (
        "gauge", "Latest weight epoch committed into the serving fleet "
                 "by the online coordinator (new admissions decode on "
                 "it; in-flight requests finish on their pinned epoch)"),
    "online_flip_seconds": (
        "histogram", "Wall time of one journaled weight-flip "
                     "transaction, publish fence through close — decode "
                     "never drains inside it"),
    "online_wt_bytes_total": (
        "counter", "Source bytes streamed as wt leaf frames, after "
                   "per-engine delta skipping (labels: engine; the wire "
                   "itself is counted by serving_transport_*)"),
    "online_flips_total": (
        "counter", "Weight-flip transactions by terminal outcome "
                   "(labels: outcome = committed|rolled_back|"
                   "rolled_forward)"),
    # -- chaos --------------------------------------------------------------
    "chaos_fault_total": (
        "counter", "Faults injected by the chaos harness (labels: fault)"),
    # -- tracing (observability/tracing.py) ---------------------------------
    "trace_spans_total": (
        "counter", "Spans recorded to the per-rank span log (labels: name)"),
}

#: JSONL event kinds (the `kind` field of every event log record).
EVENTS = {
    "xla_compile",        # a jit cache miss compiled a new executable
    "train_step",         # one training step (hapi TelemetryLogger)
    "train_run",          # fit() begin/end
    "checkpoint_save",    # a checkpoint commit (path, seconds, bytes)
    "checkpoint_restore",  # a checkpoint restore
    "elastic_resume",     # ElasticManager.resume decision (step, fallbacks)
    "worker_relaunch",    # launch supervisor relaunched a dead worker
    "watchdog_start",     # heartbeat watchdog came up on this rank
    "rank_stalled",       # watchdog diagnosed a silent rank
    "chaos_fault",        # the chaos harness injected a fault
    "store_connect_failed",  # store dial exhausted its backoff budget
    "init_parallel_env",  # multiprocess runtime bootstrap
    "fleet_aggregate",    # rank 0 merged fleet snapshots
    "serving_request_done",  # decode engine finished a request
    "reshard",            # one reshard completed (what, leaves, peak bytes)
    "reshard_stall",      # a reshard collective exceeded its deadline
    "elastic_resize",     # live fleet resize (old/new size, outcome)
    "serving_router_shed",         # admission control rejected a request
    "serving_router_failover",     # a request was resubmitted off a dead engine
    "serving_router_engine_up",    # router discovered a registered engine
    "serving_router_engine_dead",  # an engine's beat stalled past grace
    "serving_router_retransmit",   # unacked wire dispatches re-sent + mirrored
    "autoplan",           # planner chose a layout (mesh, schedule, cost)
    "compile_cache_corrupt",  # a cache entry failed to load and was evicted
    "mpmd_queue_replay",  # boundary queue replayed its unacked tail
    "mpmd_stage_resize",  # one MPMD stage changed width (old/new dp)
    "elastic_stage_resize",  # per-stage live resize moved a stage's leaves
    "slo_burn",           # windowed burn rate crossed 1.0 (live plane)
    "flip_commit",        # supervisor committed a role flip (or rolled one
                          # forward in crash recovery)
    "flip_rollback",      # supervisor rolled a flip back (pre-commit
                          # failure or crash recovery)
    "supervisor_breaker",  # flip-storm circuit breaker opened
    "rank_straggler",     # step-time EWMA z-score flagged a rank (live plane)
    "stage_imbalance",    # MPMD busy/idle spread crossed threshold (live)
    "tenant_heavy_hitter",    # a tenant surfaced in the aggregator top-K
    "tenant_ledger_reconcile",  # live ledger vs post-hoc attribution diff
    "tenant_quota_throttled",  # front tier shed a request on a dry bucket
    "frontier_hot_tenant_spread",  # a tenant entered the hot (spread) set
    "weight_flip_commit",     # online coordinator committed a weight epoch
                              # into the fleet (epoch, leaves, bytes)
    "weight_flip_rollback",   # weight flip rolled back (pre-commit
                              # failure) or retired by crash recovery
}


#: Span names (observability/tracing.py) -> (owner, help). The owner is
#: the ONE file (posix-relative to the repo root) allowed to record the
#: span, so every span name in a merged trace has exactly one producing
#: call site family. Serving spans form the
#: request tree documented in docs/OBSERVABILITY.md §9; training spans
#: are single-span traces tied to the step/commit they time.
SPANS = {
    # -- serving request tree: router process -------------------------------
    "srv_request": (
        "paddle_tpu_torch/serving/router.py",
        "Root span of one routed request: submit() through result harvest "
        "(attrs: rid, slo, status, engine, resubmits)"),
    "srv_admit": (
        "paddle_tpu_torch/serving/router.py",
        "SLO admission control: queue-limit check + class queue insert"),
    "srv_queue": (
        "paddle_tpu_torch/serving/router.py",
        "Time spent admitted-but-undispatched in the class queue "
        "(first attempt only; failover requeues are srv_retry)"),
    "srv_dispatch": (
        "paddle_tpu_torch/serving/router.py",
        "Engine selection + request record write to the coordination "
        "store (attrs: engine, seq, retry, affinity)"),
    "srv_retry": (
        "paddle_tpu_torch/serving/router.py",
        "Failover resubmission window: engine declared dead through "
        "redispatch of this request (retry=True, attrs: engine=dead one)"),
    # -- serving request tree: worker process -------------------------------
    "srv_store_transit": (
        "paddle_tpu_torch/serving/worker.py",
        "Router store write to worker drain, wall-to-wall across "
        "processes (subject to host clock skew; durations elsewhere are "
        "monotonic); emitted only on the legacy store dataplane"),
    "srv_net_transit": (
        "paddle_tpu_torch/serving/worker.py",
        "Router dispatch-frame send to worker drain over the streaming "
        "transport, wall-to-wall across processes (the dataplane hop "
        "that replaced srv_store_transit; subject to host clock skew)"),
    "srv_kv_stream": (
        "paddle_tpu_torch/serving/worker.py",
        "Disaggregated prefill handoff: prefill engine's KV-page export "
        "send through the decode engine's page import, wall-to-wall "
        "(attrs: rid, pages, wire)"),
    "srv_drain": (
        "paddle_tpu_torch/serving/worker.py",
        "Worker consumed the request record and submitted it to its "
        "local engine"),
    # -- serving request tree: engine ---------------------------------------
    "srv_prefill": (
        "paddle_tpu_torch/inference/engine.py",
        "Bucketed prompt prefill that produced the first token (attrs: "
        "bucket, cached_len, kernel — the resolved attention kernel; "
        "includes compile on a cold bucket)"),
    "srv_decode": (
        "paddle_tpu_torch/inference/engine.py",
        "The request's decode window: first batched step it joined "
        "through its finish (attrs: steps, tokens, kernel — the resolved "
        "attention kernel)"),
    "srv_verify": (
        "paddle_tpu_torch/inference/engine.py",
        "Speculative share of the decode window, child of srv_decode "
        "(attrs: steps, accepted); emitted only when the request ran "
        "draft/verify steps"),
    # -- training side ------------------------------------------------------
    "compile": (
        "paddle_tpu_torch/observability/__init__.py",
        "One jit cache miss (emitted by record_compile, so every "
        "compile-instrumented site traces for free; attrs: where, "
        "signature)"),
    "train_step": (
        "paddle_tpu_torch/jit/__init__.py",
        "One warm train-step dispatch (cache hits only; misses are "
        "'compile' spans)"),
    "pp_tick_window": (
        "paddle_tpu_torch/distributed/fleet/meta_parallel/pipeline_parallel.py",
        "Host-side pipeline schedule build for one micro-batched step "
        "(attrs: schedule, ticks, bubble_fraction); per-tick device time "
        "lives inside the single compiled program and is not host-"
        "observable"),
    "grad_comm_exchange": (
        "paddle_tpu_torch/distributed/grad_comm.py",
        "Bucketed gradient-exchange build (attrs: buckets, wire_bytes); "
        "instant marker when the caller did not time the build"),
    "ckpt_save": (
        "paddle_tpu_torch/distributed/checkpoint/__init__.py",
        "Checkpoint save, body write through commit (attrs: path)"),
    "ckpt_restore": (
        "paddle_tpu_torch/distributed/checkpoint/__init__.py",
        "Checkpoint restore (attrs: path)"),
    "reshard_exec": (
        "paddle_tpu_torch/distributed/reshard.py",
        "One reshard plan+execute over all leaves (attrs: what, leaves)"),
    "mpmd_step": (
        "paddle_tpu_torch/distributed/mpmd.py",
        "One MPMD pipelined train step: stage runners start through grad "
        "scatter (attrs: step, stages, microbatches, schedule, "
        "transport, wire)"),
    "flip": (
        "paddle_tpu_torch/distributed/fleet/supervisor.py",
        "One supervisor role-flip transaction, plan fence through "
        "finalize/rollback (attrs: id, direction, engine, outcome); "
        "trace_report attributes flip wall time against the drain/"
        "resize it covers"),
    "weight_flip": (
        "paddle_tpu_torch/serving/online.py",
        "One journaled online weight-flip transaction, publish fence "
        "through close (attrs: epoch, engines, outcome); brackets the "
        "wt stream + pointer swap, during which decode keeps running"),
}


def metric_kind(name: str):
    """Declared kind for a registered name, or None."""
    entry = METRICS.get(name)
    return entry[0] if entry else None


def span_owner(name: str):
    """Owning file (posix repo-relative) for a registered span, or None."""
    entry = SPANS.get(name)
    return entry[0] if entry else None
