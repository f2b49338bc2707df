"""Checkpoints of the port: pickle-free ``save`` / ``load`` in the JAX
package's format, whole-state tensor trees written in the background
(:class:`ShardedCheckpointer`, :func:`restore_train_state`) and the
step-numbered, crash-consistent :class:`CheckpointManager`."""
from .manager import CheckpointManager
from .serialization import load, load_state_dict, save, save_state_dict
from .sharded import (ShardedCheckpointer, load_sharded, restore_train_state,
                      save_sharded)

__all__ = [
    "CheckpointManager", "load", "load_state_dict", "save",
    "save_state_dict", "ShardedCheckpointer", "load_sharded",
    "restore_train_state", "save_sharded",
]
