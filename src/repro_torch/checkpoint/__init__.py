"""Fault-tolerant checkpoints of the port (the reference's on-disk format
and protocol)."""
from repro_torch.checkpoint.manager import CheckpointCorrupt, CheckpointManager

__all__ = ["CheckpointCorrupt", "CheckpointManager"]
