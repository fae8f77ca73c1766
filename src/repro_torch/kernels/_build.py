"""Build and load the port's CUDA kernels: each ``csrc/*.cu`` file is
compiled by nvcc into a shared library with a plain C interface and
loaded with ctypes (no reference counterpart: Pallas kernels compile
inside ``jax.jit``).

The build is lazy: nothing here runs at import, and the CPU path never
reaches it.  Libraries land in ``build/kernels/`` at the repository
root, named by a hash of the source and flags, so a stale library is
never loaded and a second process reuses the first one's build.
:func:`build` starts one nvcc per source, all at once, and waits for
all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_KERNELS = pathlib.Path(__file__).resolve().parent
#: src/repro_torch/kernels → repository root / build / kernels
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

SOURCES = {
    "pq_adc_fused": _KERNELS / "pq_adc" / "csrc" / "pq_adc_fused.cu",
    "pq_adc": _KERNELS / "pq_adc" / "csrc" / "pq_adc.cu",
    "topk_scores": _KERNELS / "assign_topk" / "csrc" / "topk_scores.cu",
    "sq8_dot_fused": _KERNELS / "sq8_dot" / "csrc" / "sq8_dot_fused.cu",
    "assign_argmax": _KERNELS / "assign_topk" / "csrc" / "assign_argmax.cu",
    "flash_attention": (_KERNELS / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    cands += [found] if found else []
    for path in cands:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source on first use")


def target(name: str) -> pathlib.Path:
    """The library path for kernel ``name`` at its current source."""
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every missing library among ``names`` (default: all),
    one nvcc process per source, all started together.  Returns
    ``{name: compiler log}`` for the libraries built by this call
    (``-Xptxas -v``: registers, shared memory, spills)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log))
    logs, failed = {}, []
    for name, proc, tmp, out, log in jobs:
        rc = proc.wait()
        logs[name] = log.read_text()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(target(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry."""
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
