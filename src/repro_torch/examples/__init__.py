"""Examples of the port (counterparts of the reference's ``examples/``):
:mod:`.quickstart`, :mod:`.serve_retrieval` and
:mod:`.train_hi2_distill`, each run as ``python -m
repro_torch.examples.<name> [--device cpu]``."""
