"""The one generator of question traffic, driven by a traffic file.

A mix is drawn once from the file's ``mix_seed``: prompt and answer
lengths (log-normal, clipped to their ranges: long-tailed), one
sequence of them a client. ``--seed`` then only deals the sequences to
the cameras, so every seed offers the same work. The question's text
(``question``: ``describe``, or ``mc`` for a multiple-choice question)
names an event its camera has shown; its prompt opens with the text's
words and is filled to its length with ids from the seed."""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from perfbench.reference.text import word_id
from perfbench.world import OBJECTS, derive_seed


@dataclass
class Question:
    sid: int
    text: str
    prompt: np.ndarray          # int32 prompt token ids
    max_new_tokens: int


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` long-tailed lengths: log-normal around ``median`` with
    ``sigma``, rounded and clipped to [min, max]."""
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _text(kind: str, cam: int, ev: int, rng) -> str:
    obj = OBJECTS[ev % len(OBJECTS)]
    if kind == "describe":
        return f"describe what happened on camera {cam} around event{ev}"
    opts = " ".join(f"{c} {OBJECTS[int(o)]}" for c, o in
                    zip("abcd", rng.integers(len(OBJECTS), size=4)))
    return f"when did camera {cam} see event{ev} with the {obj} ? {opts}"


def question(traffic: dict, world, cam: int, prompt_len: int,
             max_new: int, rng, vocab: int, seen_upto: int) -> Question:
    events = world.events_seen(cam, seen_upto)
    ev = int(events[int(rng.integers(len(events)))])
    text = _text(traffic["question"], cam, ev, rng)
    words = [word_id(w, vocab) for w in text.lower().split()][:prompt_len]
    fill = rng.integers(3, vocab, size=prompt_len - len(words))
    prompt = np.concatenate([np.asarray(words, np.int64), fill]).astype(
        np.int32)
    return Question(cam, text, prompt, int(max_new))


class ClosedLoop:
    """One client a camera; ``next(cam)`` is that client's next
    question. The mix holds one sequence of lengths a client; the seed
    deals the sequences to the cameras."""

    def __init__(self, traffic: dict, seed: int, world, vocab: int,
                 seen_upto: int):
        self.per = traffic["pool"] // world.streams
        n = self.per * world.streams
        mix = np.random.default_rng(traffic["mix_seed"])
        self.plen = lengths(traffic["prompt_tokens"], n, mix)
        self.alen = lengths(traffic["answer_tokens"], n, mix)
        self.rng = np.random.default_rng(derive_seed("questions", seed))
        self.deal = self.rng.permutation(world.streams)
        self.asked = [0] * world.streams
        self.traffic, self.world, self.vocab = traffic, world, vocab
        self.seen_upto = seen_upto

    def next(self, cam: int) -> Question:
        j = int(self.deal[cam]) * self.per + self.asked[cam] % self.per
        self.asked[cam] += 1
        return question(self.traffic, self.world, cam, int(self.plen[j]),
                        int(self.alen[j]), self.rng, self.vocab,
                        self.seen_upto)
