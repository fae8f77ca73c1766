"""Device resolution for the port's entry points (no reference
counterpart: the JAX package places arrays on its default backend).

Every entry point takes ``device=`` defaulting to ``"cuda"``; there is
no silent CPU fallback — a run that asked for the card and found none
fails loudly instead of reporting CPU behaviour as the card's.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device` with its index filled in
    (``"cuda"`` → ``cuda:<current>``); raises when it names CUDA and no
    card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array / tensor / sequence → tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=dtype, device=device)
