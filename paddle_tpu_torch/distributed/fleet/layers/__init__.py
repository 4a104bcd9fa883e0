from . import mpu  # noqa: F401
from .mpu import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    get_rng_state_tracker,
)
