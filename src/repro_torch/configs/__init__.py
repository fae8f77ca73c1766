"""Architecture configs and the registry (port of ``repro/configs``):
the recsys family (``dlrm_rm2``, ``sasrec``, ``dien``, ``mind``) and the
paper's own ``hi2_synth`` cells; the LM and GNN configs come with their
models."""
