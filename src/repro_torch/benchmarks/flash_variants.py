"""A ``flash_attention`` kernel change against its parent, in one process
on one card.

    git show HEAD:src/repro_torch/kernels/flash_attention/csrc/\\
flash_attention.cu > build/flash_parent.cu
    python -m repro_torch.benchmarks.flash_variants \\
        --parent build/flash_parent.cu

``HEAD`` is the parent while the change is not yet committed (after
committing it, ``HEAD~1``).  Builds the parent's source and this
checkout's ``csrc/flash_attention.cu`` with nvcc, in parallel, and
prints each instance's ``ptxas`` registers and spills.  Then, at the
HI²_sup encoder chunk's shape (B 4,096, H 12, S 64, d 64 f32,
non-causal) and at llama3-8b's attention (B 1, S 4,096, Hq 32, Hkv 8, d
128 bf16, causal): holds both builds against the plain version (f32 out
within 1e-4, bf16 within 2e-2, lse within 1e-4; the change in both load
instances) and times each with CUDA events, the 50 MB L2 flushed before
every launch, in the order parent, change, change, parent, beside
``scaled_dot_product_attention`` and the bound (the larger of bytes at
3.35 TB/s and FLOPs at 67 TFLOP/s).  The last line is a JSON object of
the times (ms).  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "build" / "flash_variants"
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def takes_vec(source: str) -> bool:
    """Whether a ``flash_attention.cu``'s C entry takes the ``vec`` flag
    (sources from before the element-wise load instance do not)."""
    entry = re.search(r"int flash_attention_fwd\(([^)]*)\)", source)
    if entry is None:
        raise ValueError("no flash_attention_fwd C entry in the source")
    return re.search(r"\bint vec\b", entry.group(1)) is not None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="the parent's csrc/flash_attention.cu")
    ap.add_argument("--reps", type=int, default=20)
    return ap.parse_args(argv)


def build(sources: dict) -> dict:
    """{name: source path} → {name: loaded library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(OUT_DIR / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name} failed to build:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {entry[-40:]}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    return libs


def call(lib, with_vec: bool, q, k, v, causal: bool, vec: bool = True):
    """One launch through ``ops``' calling convention; ``with_vec`` False
    drops the ``vec`` argument for a C entry that lacks it."""
    out, lse = ops.outputs(q)
    args = ops.kernel_args(q, k, v, out, lse, causal, 0,
                           q.shape[-1] ** -0.5,
                           vec and ops.vector_loads(q, k, v, out),
                           torch.cuda.current_stream().cuda_stream)
    argtypes = list(ops.ARGTYPES)
    if not with_vec:
        del args[-2], argtypes[-2]
    fn = lib.flash_attention_fwd
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build.check(lib, fn(*args), "flash_attention")
    return out, lse


def shapes(gen):
    def bshd(b, s, h, d, dtype):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    yield "encoder", dict(
        qkv=[bshd(4096, 64, 12, 64, torch.float32) for _ in range(3)],
        causal=False, flops=4.0 * 4096 * 12 * 64 * 64 * 64,
        nbytes=4.0 * (4 * 4096 * 12 * 64 * 64 + 4096 * 12 * 64),
        library=lambda q, k, v: sdpa(q, k, v))
    yield "llama3_8b", dict(
        qkv=[bshd(1, 4096, 32, 128, torch.bfloat16)]
        + [bshd(1, 4096, 8, 128, torch.bfloat16) for _ in range(2)],
        causal=True, flops=4.0 * 32 * 4096 * 4096 * 128 / 2,
        nbytes=2.0 * 4096 * 128 * (2 * 32 + 2 * 8),
        library=lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                     enable_gqa=True))


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_variants: needs an NVIDIA card")
    with_vec = {"parent": takes_vec(args.parent.read_text()), "new": True}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build({"parent": args.parent,
                  "new": _build.SOURCES["flash_attention"]})
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(fn, reps):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    report = {}
    for sname, sh in shapes(torch.Generator(device="cuda").manual_seed(0)):
        q, k, v = sh["qkv"]
        want, wlse = ref.flash_attention(q, k, v, sh["causal"], 0)
        tol = 1e-4 if q.dtype == torch.float32 else 2e-2
        for name, lib in libs.items():
            for vec in (True, False)[:1 + with_vec[name]]:
                out, lse = call(lib, with_vec[name], q, k, v, sh["causal"],
                                vec)
                err = float((out.float() - want.float()).abs().max())
                ok = (torch.allclose(out.float(), want.float(), rtol=tol,
                                     atol=tol)
                      and torch.allclose(lse, wlse, rtol=1e-4, atol=1e-4))
                print(f"[check] {sname} {name} vec={vec}: max abs out err "
                      f"{err:.3g} {'ok' if ok else 'FAILED'}", flush=True)
                if not ok:
                    sys.exit(f"{name} disagrees with the plain version")
        del want, wlse
        times = {}
        for name in ("parent", "new", "new", "parent"):
            times.setdefault(name, []).append(ms(
                lambda: call(libs[name], with_vec[name], q, k, v,
                             sh["causal"]), args.reps))
        times["new_scalar"] = [ms(
            lambda: call(libs["new"], True, q, k, v, sh["causal"], False),
            max(args.reps // 2, 3))]
        times["library"] = [ms(lambda: sh["library"](q, k, v), args.reps)
                            for _ in range(2)]
        bound = 1e3 * max(sh["flops"] / PEAK_FP32_FLOPS,
                          sh["nbytes"] / PEAK_BYTES)
        report[sname] = dict(bound_ms=bound, **times)
        print(f"[times] {sname}: bound {bound:.3f} ms; " + "; ".join(
            f"{n} {' / '.join(f'{t:.3f}' for t in ts)}"
            for n, ts in times.items()), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
