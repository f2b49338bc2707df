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
from .memory_efficient import (MemoryEfficientAdamW, QMoment,
                               dequantize_blockwise, quantize_blockwise,
                               stochastic_round)
from .optimizer import (LARS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        Lamb, Momentum, Optimizer, RMSProp)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "ConstantLR", "CosineAnnealingDecay", "CyclicLR",
           "ExponentialDecay", "GradClipBase", "InverseTimeDecay", "LARS",
           "LRScheduler", "Lamb", "LambdaDecay", "LinearWarmup",
           "MemoryEfficientAdamW", "Momentum", "MultiStepDecay",
           "MultiplicativeDecay", "NaturalExpDecay", "NoamDecay",
           "OneCycleLR", "Optimizer", "PiecewiseDecay", "PolynomialDecay",
           "QMoment", "RMSProp", "ReduceOnPlateau", "SGD", "StepDecay",
           "clip", "dequantize_blockwise", "global_norm", "lr",
           "quantize_blockwise", "stochastic_round"]
