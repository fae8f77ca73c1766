"""Synthetic recsys click/behaviour batches, DLRM / SASRec / DIEN / MIND
(port of ``repro/data/recsys.py``: the same numpy draws from the same
``seed``, so the arrays equal the reference's bit for bit; the tensors
go on ``device``).

Clicks follow a latent-factor model so training actually reduces loss:
user/item factors are drawn once per seed; labels = σ(⟨u, v⟩ + noise).
"""
from __future__ import annotations

import numpy as np

from repro_torch import device as dev_mod
from repro_torch.models.recsys import (DIENBatch, DLRMBatch, MINDBatch,
                                       SASRecBatch)


def _on(dev, *arrays):
    return tuple(dev_mod.as_tensor(a, dev) for a in arrays)


def dlrm_batch(seed: int, batch: int, n_dense: int = 13, n_sparse: int = 26,
               n_rows: int = 1_000_000,
               device: dev_mod.DeviceLike = "cuda") -> DLRMBatch:
    dev = dev_mod.resolve(device)
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    sparse = rng.integers(0, n_rows, size=(batch, n_sparse)).astype(np.int32)
    # clickiness correlates with the dense features → learnable signal
    w = np.linspace(-1, 1, n_dense)
    p = 1 / (1 + np.exp(-(dense @ w + rng.normal(size=batch) * 0.5)))
    labels = (rng.random(batch) < p).astype(np.float32)
    return DLRMBatch(*_on(dev, dense, sparse, labels))


def sasrec_batch(seed: int, batch: int, seq_len: int = 50,
                 n_items: int = 1_000_000,
                 device: dev_mod.DeviceLike = "cuda") -> SASRecBatch:
    dev = dev_mod.resolve(device)
    rng = np.random.default_rng(seed)
    # random-walk sequences in item space → local transition structure
    start = rng.integers(0, n_items, batch)
    steps = rng.integers(-50, 51, size=(batch, seq_len)).cumsum(axis=1)
    items = ((start[:, None] + steps) % n_items).astype(np.int32)
    targets = np.roll(items, -1, axis=1)
    targets[:, -1] = rng.integers(0, n_items, batch)
    negs = rng.integers(0, n_items, size=(batch, seq_len)).astype(np.int32)
    return SASRecBatch(*_on(dev, items, targets, negs))


def dien_batch(seed: int, batch: int, seq_len: int = 100,
               n_items: int = 1_000_000,
               device: dev_mod.DeviceLike = "cuda") -> DIENBatch:
    dev = dev_mod.resolve(device)
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, n_items, size=(batch, seq_len)).astype(np.int32)
    target = rng.integers(0, n_items, batch).astype(np.int32)
    # positive iff the target's category (id % C) appears in the history
    c = max(n_items // 100, 16)
    labels = (np.isin(target % c, hist % c, assume_unique=False) &
              (rng.random(batch) < 0.9)).astype(np.float32)
    return DIENBatch(*_on(dev, hist, target, labels))


def mind_batch(seed: int, batch: int, seq_len: int = 50, n_neg: int = 10,
               n_items: int = 1_000_000,
               device: dev_mod.DeviceLike = "cuda") -> MINDBatch:
    dev = dev_mod.resolve(device)
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, n_items, size=(batch, seq_len)).astype(np.int32)
    target = hist[np.arange(batch), rng.integers(0, seq_len, batch)]
    negs = rng.integers(0, n_items, size=(batch, n_neg)).astype(np.int32)
    return MINDBatch(*_on(dev, hist, target.astype(np.int32), negs))
