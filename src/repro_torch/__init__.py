"""repro_torch — the PyTorch / CUDA port of the HI² index build and
serving path for one NVIDIA H100, beside the JAX reference package in
``src/repro/``.

The layout mirrors the reference (``core/``, ``core/codecs/``,
``core/exec/``, ``kernels/``, ``checkpoint/``, ``launch/``, ``data/``);
each module names the reference file it answers to.  The package
imports torch and numpy only — never jax, never the reference package.

Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise unless the caller asks for ``device="cpu"``.  Kernels are
chosen by tensor device — a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor takes the kernel's plain PyTorch version.

Float32 matmuls run in full fp32 (no TF32): the cluster-dispatch top-K^C
must give the same list ids as the plain path on near-ties.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
