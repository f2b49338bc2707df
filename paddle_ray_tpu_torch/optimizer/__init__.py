"""Optimizers of the port."""
from . import lr
from .lr import ConstantLR, LRScheduler
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "ConstantLR", "LRScheduler", "Optimizer", "lr"]
