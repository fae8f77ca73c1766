"""Hash tokenizer (port of ``repro/data/tokenizer.py``: ``PAD_ID``,
``tokenize`` and ``tokenize_batch``) — deterministic text → fixed-vocab
ids with no vocabulary file.  Each lowercase ASCII word is hashed with
BLAKE2b (4-byte digest, little endian) modulo the vocabulary, so the ids
equal the reference's for any text.  Host-side numpy: the ids go to a
device with the rest of a batch.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np

PAD_ID = -1
_WORD_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str, vocab_size: int, max_len: int) -> np.ndarray:
    """(max_len,) int32 ids: the first ``max_len`` words of the lowercased
    text, each hashed into [0, vocab_size), then ``PAD_ID``."""
    words = _WORD_RE.findall(text.lower())[:max_len]
    ids = [int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(),
                          "little") % vocab_size
           for w in words]
    out = np.full(max_len, PAD_ID, np.int32)
    out[:len(ids)] = ids
    return out


def tokenize_batch(texts: list[str], vocab_size: int,
                   max_len: int) -> np.ndarray:
    """(len(texts), max_len) int32 ids, one row a text."""
    return np.stack([tokenize(t, vocab_size, max_len) for t in texts])
