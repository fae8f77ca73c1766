"""Checkpoints (port of ``repro/checkpoint``: index and mutable-index
checkpoints written and read in the reference's layout, and
``CheckpointManager``'s rotation)."""
