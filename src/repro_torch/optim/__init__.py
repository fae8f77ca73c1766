"""Optimisation (port of ``repro/optim``: AdamW, the schedules and the
gradient tools; ``compression.py``, which serves cross-pod gradient
traffic, comes with ROADMAP.md A4b)."""
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update)
from repro_torch.optim.grad import (accumulate_grads, clip_by_global_norm,
                                    global_norm, value_and_grad)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup, warmup_cosine)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update",
           "accumulate_grads", "clip_by_global_norm", "global_norm",
           "value_and_grad", "constant", "cosine_decay", "linear_warmup",
           "warmup_cosine"]
