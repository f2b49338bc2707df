"""Crash-consistent training (the port of ``paddle_ray_tpu/train``):
:class:`TrainFaultPlan` and :class:`PreemptSignal` (:mod:`.chaos`), and
:class:`ResilientTrainLoop` (:mod:`.loop`), which saves
:meth:`TrainState.capture <..parallel.api.TrainState.capture>` through a
:class:`~..checkpoint.CheckpointManager` and resumes bit for bit after a
kill anywhere."""
from .chaos import (ChaosKill, PreemptSignal, TRAIN_FAULT_KINDS,
                    TrainFaultEvent, TrainFaultPlan)
from .loop import ResilientTrainLoop, TrainRunResult

__all__ = [
    "ChaosKill", "PreemptSignal", "ResilientTrainLoop",
    "TRAIN_FAULT_KINDS", "TrainFaultEvent", "TrainFaultPlan",
    "TrainRunResult",
]
