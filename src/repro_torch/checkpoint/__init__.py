"""Atomic, verified checkpoints in the JAX package's on-disk layout."""
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step, \
    committed_steps, AsyncCheckpointer, save_fit_result, \
    restore_fit_result, gc_checkpoints, verify_checkpoint, \
    quarantine_checkpoint, latest_verified_step, CorruptCheckpointError, \
    save_train_state, restore_train_state

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "committed_steps", "AsyncCheckpointer", "save_fit_result",
           "restore_fit_result", "gc_checkpoints", "verify_checkpoint",
           "quarantine_checkpoint", "latest_verified_step",
           "CorruptCheckpointError", "save_train_state",
           "restore_train_state"]
