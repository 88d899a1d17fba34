"""Byte-pair-free word-hash tokenizer: queries, aux prompts and captions
map to stable ids within the model's vocab (blake2s of each lower-cased
word), exactly the reference's ids."""

from __future__ import annotations

import hashlib
from typing import List, Tuple

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
