"""Tensor-parallel layers of the port (degree 1 in this slice)."""
from .tp import ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
