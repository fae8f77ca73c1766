"""Optimisation (port of ``repro/optim``: AdamW, the schedules, the
gradient tools and the int8 gradient compression with error feedback
that serves cross-pod gradient traffic)."""
from repro_torch.optim import compression
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update, adam_update_)
from repro_torch.optim.grad import (accumulate_grads, clip_by_global_norm,
                                    clip_by_global_norm_, global_norm,
                                    value_and_grad)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup, warmup_cosine)

__all__ = ["compression", "AdamConfig", "AdamState", "adam_init",
           "adam_update", "adam_update_", "accumulate_grads",
           "clip_by_global_norm", "clip_by_global_norm_", "global_norm",
           "value_and_grad", "constant", "cosine_decay", "linear_warmup",
           "warmup_cosine"]
