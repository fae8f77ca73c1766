"""Architecture configs and the registry (port of ``repro/configs``):
the recsys family (``dlrm_rm2``, ``sasrec``, ``dien``, ``mind``), the
GNN (``gatedgcn``), the dense LMs (``llama3_8b``, ``internlm2_1_8b``,
``stablelm_3b``), the MoE LMs (``mixtral_8x22b``, ``olmoe_1b_7b``) and
the paper's own ``hi2_synth`` cells."""
