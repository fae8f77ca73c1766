"""Fused gather + dequantized dot kernel for the SQ8 codec (port of
``repro/kernels/sq8_dot``: the ``sq8_dot_fused`` entry)."""
