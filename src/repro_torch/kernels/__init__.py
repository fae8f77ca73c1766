"""Hand-written Hopper (sm_90a) kernels of the port, one subpackage per
reference kernel family in ``repro/kernels``:

    pq_adc/       pq_adc_fused  — gather + ADC + live mask (PQ/OPQ score)
    assign_topk/  topk_scores   — fused x·embᵀ + running top-k (dispatch)
    sq8_dot/      sq8_dot_fused — gather + dequantized dot + live mask
                                  (SQ8 score)

Each has ``csrc/`` (CUDA C++ with a plain C entry), ``ref.py`` (the
plain PyTorch version, taken for CPU tensors) and ``ops.py`` (the
checked wrapper with its launch counter).  :mod:`._build` compiles the
sources with nvcc on first use.
"""
