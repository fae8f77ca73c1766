"""Checkpoints (port of ``repro/checkpoint``: the read side of index
checkpoints)."""
