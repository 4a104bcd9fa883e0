"""``fleet.meta_parallel`` counterparts: the mp layers, the pipeline
(``PipelineLayer`` / ``PipelineParallel`` / ``SpmdPipeline`` and the
descriptors), ``TensorParallel`` and the ZeRO wrappers."""
from ..layers.mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    get_rng_state_tracker,
)
from .pipeline_parallel import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    PipelineParallel,
    SharedLayerDesc,
    SpmdPipeline,
)
from .sharding import (  # noqa: F401
    GroupShardedStage1,
    GroupShardedStage2,
    GroupShardedStage3,
)
from .tensor_parallel import TensorParallel  # noqa: F401
