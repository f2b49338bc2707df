"""Parallel training of the port: tensor-parallel layers (degree 1 in
this slice) and the single-device train step."""
from .api import TrainState, build_train_step
from .tp import (ColumnParallelLinear, ParallelCrossEntropy,
                 RowParallelLinear, VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "TrainState", "VocabParallelEmbedding",
           "build_train_step"]
