"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/strategy.py``, copied: it is plain Python).

One typed object holds every distributed knob, with the reference's names
and defaults, so a training script's strategy blocks run unchanged.
:func:`check_ported`, which ``fleet.init`` and
``fleet.distributed_optimizer`` call, validates the wires before any
process group is set up. ``auto_plan`` (``DistributedStrategy.auto()``)
has ``fleet.init`` fill the unset layout knobs from the auto-parallel
planner. ``dgc`` / ``localsgd`` warn and are ignored, as in the reference
(a deliberate non-goal there too).
"""
from __future__ import annotations

from typing import Any, Dict


class _SubConfig(dict):
    """Dict with attribute access, tolerant of unknown keys."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # hybrid parallel degrees
        self.hybrid_configs: _SubConfig = _SubConfig(
            dp_degree=1,
            mp_degree=1,
            pp_degree=1,
            sharding_degree=1,
            sep_degree=1,
            order=["dp", "pp", "sharding", "sep", "mp"],
        )
        self.amp = False
        self.amp_configs: _SubConfig = _SubConfig(
            init_loss_scaling=32768.0,
            use_dynamic_loss_scaling=True,
            use_pure_fp16=False,
            use_bf16=True,
            custom_white_list=[],
            custom_black_list=[],
        )
        self.recompute = False
        self.recompute_configs: _SubConfig = _SubConfig(checkpoints=[])
        # sharding (ZeRO): stage 1 / 2 over the `sharding` axis
        self.sharding = False
        self.sharding_configs: _SubConfig = _SubConfig(
            sharding_degree=1, stage=1, offload=False
        )
        self.pipeline = False
        self.pipeline_configs: _SubConfig = _SubConfig(
            micro_batch_size=1, accumulate_steps=1, schedule_mode="1F1B",
            schedule="gpipe", virtual_pp_degree=1,
        )
        self.gradient_merge = False
        self.gradient_merge_configs: _SubConfig = _SubConfig(k_steps=1,
                                                             avg=True)
        self.lamb = False
        self.lamb_configs: _SubConfig = _SubConfig(
            lamb_weight_decay=0.01, exclude_from_weight_decay=[]
        )
        self.lars = False
        self.lars_configs: _SubConfig = _SubConfig(
            lars_coeff=0.001, lars_weight_decay=0.0005,
            exclude_from_weight_decay=[], epsilon=0.0,
        )
        self.dgc = False
        self.dgc_configs: _SubConfig = _SubConfig(rampup_begin_step=0)
        self.localsgd = False
        self.localsgd_configs: _SubConfig = _SubConfig(k_steps=1,
                                                       begin_step=1)
        self.adaptive_localsgd = False
        self.fuse_all_reduce_ops = True
        # the gradient buckets' size (distributed/grad_comm.py)
        self.fuse_grad_size_in_MB = 32
        self.grad_comm = False
        self.grad_comm_configs: _SubConfig = _SubConfig(
            wire_dtype="f32", error_feedback=False,
            zero_update=True, pipeline_batch_shard=True, overlap=True,
        )
        self.mp_comm = False
        self.mp_comm_configs: _SubConfig = _SubConfig(
            wire_dtype="f32", error_feedback=False,
            zero_gather=True, logit_verify=True,
        )
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.without_graph_optimization = False
        self.tensor_parallel = False
        self.tensor_parallel_configs: _SubConfig = _SubConfig(
            tensor_parallel_degree=1, tensor_init_seed=-1
        )
        self.auto_plan = False
        self.auto_plan_configs: _SubConfig = _SubConfig(model_config=None)

    @classmethod
    def auto(cls, model_config: Any = None) -> "DistributedStrategy":
        """A strategy whose layout is chosen by the auto-parallel planner.

        ``fleet.init`` runs ``auto_parallel.planner.apply_auto_plan``: the
        hybrid degrees, the schedule and the micro-batch count the user
        did not set are filled from the cost model (manual settings win).
        ``model_config`` is a ``planner.ModelConfig`` or a dict of its
        fields (hidden, layers, heads, vocab, seq_len, global_batch ...)."""
        s = cls()
        s.auto_plan = True
        s.auto_plan_configs.model_config = model_config
        return s

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (dict(v) if isinstance(v, _SubConfig) else v)
            for k, v in self.__dict__.items()
        }

    def __repr__(self):
        lines = ["DistributedStrategy("]
        for k, v in self.to_dict().items():
            lines.append(f"  {k}={v},")
        return "\n".join(lines) + ")"


def check_ported(strategy: DistributedStrategy):
    """Validate the strategy before any process group is set up: a wire
    dtype that neither exchange knows raises ``ValueError`` here. Every
    knob of the strategy is ported, ``auto_plan`` (the planner) last."""
    from ..grad_comm import resolve_config
    from ..mp_comm import resolve_config as resolve_mp_config

    resolve_config(strategy)  # a bad wire raises here
    resolve_mp_config(strategy)
