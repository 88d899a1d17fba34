"""Byte-pair-free word-hash tokenizer: queries, aux prompts and captions
map to stable ids within the model's vocab (blake2s of each lower-cased
word), exactly the reference's ids; and the synthetic LM token stream the
trainer and its launcher read, the reference's numbers for a seed."""

from __future__ import annotations

import hashlib
from typing import Iterator, List, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2
_RESERVED = 3


def tokenize(text: str, vocab_size: int, max_len: int,
             add_special: bool = True) -> np.ndarray:
    ids: List[int] = [BOS] if add_special else []
    for w in text.lower().split():
        h = int.from_bytes(hashlib.blake2s(w.encode(),
                                           digest_size=4).digest(), "big")
        ids.append(_RESERVED + (h % (vocab_size - _RESERVED)))
    if add_special:
        ids.append(EOS)
    ids = ids[:max_len]
    out = np.full((max_len,), PAD, np.int32)
    out[: len(ids)] = ids
    return out


def tokenize_batch(texts: List[str], vocab_size: int, max_len: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    toks = np.stack([tokenize(t, vocab_size, max_len) for t in texts])
    mask = toks != PAD
    return toks, mask


def lm_batches(vocab_size: int, batch: int, seq: int, seed: int = 0
               ) -> Iterator[dict]:
    """Markov-ish synthetic token stream with learnable structure: each
    next token follows a fixed random transition with probability 0.8,
    else is uniform noise. Yields numpy ``tokens`` and ``labels`` (the
    tokens shifted by one), (batch, seq) int32 each."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(_RESERVED, vocab_size,
                         size=(min(vocab_size, 4096),), dtype=np.int32)
    while True:
        x = np.empty((batch, seq + 1), np.int32)
        x[:, 0] = rng.integers(_RESERVED, vocab_size, size=(batch,))
        for t in range(seq):
            follow = trans[x[:, t] % len(trans)]
            noise = rng.integers(_RESERVED, vocab_size, size=(batch,))
            pick = rng.random(batch) < 0.8
            x[:, t + 1] = np.where(pick, follow, noise)
        yield {"tokens": x[:, :-1], "labels": x[:, 1:]}
