"""Peak device memory of the LM cells that fill one card: one
training-cell step (``launch/train.py::cell_step``, in place) at
train_4k's S for each batch size, or the serving path's two prefills
(prefill_32k's S at B 1, then B 8 × 4,096) for each depth, at an arch's
``make_config()`` width; the sizes go up until one runs out of memory.
It sizes the batch and depth cuts of ``chip_smoke.py``'s phases 25–26
and, as they do, makes the allocator's segments expandable.

    python -m repro_torch.benchmarks.lm_memory --arch olmoe-1b-7b \\
        --layers 8 --train-batches 10 12 13 14
    python -m repro_torch.benchmarks.lm_memory --arch mixtral-8x22b \\
        --layers 1 --train-batches 6 8 10 --serve-layers 4 5

Needs a card (no CPU path: its numbers are device memory)."""
from __future__ import annotations

import argparse
import dataclasses
import gc
import time

import torch

from repro_torch import device as dev_mod
from repro_torch import optim
from repro_torch.configs import registry, shapes
from repro_torch.launch import train
from repro_torch.models import transformer as tfm


def _fresh() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _tokens(cfg, b: int, s: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)


def train_peak(cfg, b: int, dev) -> tuple[float, float]:
    """(ms, peak GB) of one in-place cell step at B ``b``, train_4k's S,
    from fresh parameters and AdamW state."""
    _fresh()
    s = shapes.LM_SHAPES["train_4k"].seq_len
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    ids = _tokens(cfg, b, s + 1, dev)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    t0 = time.perf_counter()
    train.cell_step(tfm.cell_loss, cfg, params, optim.adam_init(params),
                    batch)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 1e9)


def serve_peak(cfg, dev) -> float:
    """Peak GB of fresh weights, prefill_32k's prefill at B 1, then a
    B 8 × 4,096 prefill."""
    _fresh()
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    tfm.prefill_step(params, cfg, _tokens(
        cfg, 1, shapes.LM_SHAPES["prefill_32k"].seq_len, dev))
    tfm.prefill_step(params, cfg, _tokens(cfg, 8, 4096, dev))
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=1,
                    help="depth of the training steps")
    ap.add_argument("--train-batches", type=int, nargs="*", default=())
    ap.add_argument("--serve-layers", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    dev = dev_mod.resolve("cuda")
    torch.cuda.set_device(dev)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    full = registry.get(args.arch).make_config()
    print(f"[lm_memory] {torch.cuda.get_device_name(dev)}, "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} "
          f"GB", flush=True)
    cfg = dataclasses.replace(full, n_layers=args.layers)
    for b in args.train_batches:
        try:
            ms, peak = train_peak(cfg, b, dev)
        except torch.OutOfMemoryError:
            print(f"[lm_memory] train {args.arch} L {args.layers} B {b}: "
                  f"out of memory", flush=True)
            break
        print(f"[lm_memory] train {args.arch} L {args.layers} B {b}: "
              f"{ms:.0f} ms, peak {peak:.2f} GB", flush=True)
    for n in args.serve_layers:
        try:
            peak = serve_peak(dataclasses.replace(full, n_layers=n), dev)
        except torch.OutOfMemoryError:
            print(f"[lm_memory] serve {args.arch} L {n}: out of memory",
                  flush=True)
            break
        print(f"[lm_memory] serve {args.arch} L {n}: peak {peak:.2f} GB",
              flush=True)


if __name__ == "__main__":
    main()
