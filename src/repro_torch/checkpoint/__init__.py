"""Fault-tolerant checkpointing (atomic writes, async snapshots,
device-agnostic restore) in the reference's on-disk format."""

from repro_torch.checkpoint.manager import (
    CheckpointManager,
    CorruptCheckpointError,
    restore_tree,
    save_tree,
)
