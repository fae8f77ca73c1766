"""Flash attention, forward (port of ``repro/kernels/flash_attention``:
the ``flash_attention`` entry; its gradient comes with training)."""
