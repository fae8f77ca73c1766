"""The ADC kernels (port of ``repro/kernels/pq_adc``): ``pq_adc_fused``
(gather + ADC + live mask) and ``pq_adc`` (ADC over pre-gathered codes,
the reference's ``pq_adc_fragmajor``)."""
