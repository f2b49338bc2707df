"""Optimizers of the port, their gradient clips and learning-rate
schedules."""
from . import clip, lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradClipBase, global_norm)
from .lr import (ConstantLR, CosineAnnealingDecay, CyclicLR,
                 ExponentialDecay, InverseTimeDecay, LambdaDecay,
                 LinearWarmup, LRScheduler, MultiplicativeDecay,
                 MultiStepDecay, NaturalExpDecay, NoamDecay, OneCycleLR,
                 PiecewiseDecay, PolynomialDecay, ReduceOnPlateau, StepDecay)
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "ConstantLR", "CosineAnnealingDecay",
           "CyclicLR", "ExponentialDecay", "GradClipBase",
           "InverseTimeDecay", "LRScheduler", "LambdaDecay", "LinearWarmup",
           "MultiStepDecay", "MultiplicativeDecay", "NaturalExpDecay",
           "NoamDecay", "OneCycleLR", "Optimizer", "PiecewiseDecay",
           "PolynomialDecay", "ReduceOnPlateau", "StepDecay", "clip",
           "global_norm", "lr"]
