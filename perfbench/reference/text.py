"""The word-hash tokenizer the MEM text tower reads (blake2s of each
lower-cased word, ids from 3 up; 1 and 2 open and close a text; 0 pads),
written from its definition."""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2
RESERVED = 3


def word_id(word: str, vocab_size: int) -> int:
    h = int.from_bytes(hashlib.blake2s(word.encode(), digest_size=4).digest(),
                       "big")
    return RESERVED + h % (vocab_size - RESERVED)


def tokenize(text: str, vocab_size: int, max_len: int) -> np.ndarray:
    ids = [BOS] + [word_id(w, vocab_size) for w in text.lower().split()]
    ids = (ids + [EOS])[:max_len]
    out = np.full((max_len,), PAD, np.int64)
    out[:len(ids)] = ids
    return out


def tokenize_batch(texts: List[str], vocab_size: int, max_len: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    toks = np.stack([tokenize(t, vocab_size, max_len) for t in texts])
    return toks, toks != PAD
