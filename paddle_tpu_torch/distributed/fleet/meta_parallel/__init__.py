"""``fleet.meta_parallel`` counterparts: the mp layers, ``TensorParallel``
and the ZeRO wrappers. ``PipelineLayer`` / ``PipelineParallel`` /
``SpmdPipeline`` wait for pipeline parallelism (ROADMAP.md §A.7)."""
from ..layers.mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    get_rng_state_tracker,
)
from .sharding import (  # noqa: F401
    GroupShardedStage1,
    GroupShardedStage2,
    GroupShardedStage3,
)
from .tensor_parallel import TensorParallel  # noqa: F401
