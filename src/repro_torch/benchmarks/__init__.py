"""Benchmarks of the port (counterparts of the reference's
``benchmarks/``): the kernel, serving, streaming, tuner and
distillation benches, and the paper's tables and figures
(:mod:`.table1_main`, :mod:`.table2_robustness`, :mod:`.table3_codec`,
:mod:`.fig3_tradeoff`, :mod:`.fig4_ablation`, over :mod:`.common`),
:mod:`.hybrid_fusion` and :mod:`.filtered_search`."""
