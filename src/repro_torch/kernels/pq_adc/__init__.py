"""Fused gather + ADC kernel (port of ``repro/kernels/pq_adc``: the
``pq_adc_fused`` entry; ``pq_adc_fragmajor`` is still to be ported)."""
