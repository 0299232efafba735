"""The one traffic generator: batches of synthesis requests drawn from the
seed, as a traffic file's parameters say.

Parameters (portbench/traffic/<name>.json):
- `batch`: requests a batch;
- `prompts`: directory of voice prompts (`.npz` with `audio_tokens`
  (1, T, 8), `text_tokens` (1, S), `lang_code`), relative to the checkout;
  read as data, in name order;
- `prompt_frames`: [lo, hi], the prompts whose frame count lies within;
- `text_phonemes`: [lo, hi], the new text's phonemes a request, uniform;
- `phoneme_ids`: [lo, hi], the phoneme ids drawn, uniform.

The first GREEDY_BATCHES batches of a stream decode greedily (top_k 1), so
that the check has greedy tokens to judge; every other batch samples as the
configuration's engine says (its `top_k`, `top_p` and `temperature`).

Each batch holds floor(batch / P) whole permutations of the P prompts and
then one prompt from each of batch mod P strata of the prompts sorted by
length (stratum j: the j-th of batch mod P equal slices), all drawn from
the seed: a batch of 48 over 41 prompts holds each prompt once and one
more from each seventh of the lengths, a batch of 24 one from each 24th.
So every batch has about the same prompt lengths, and every seed the same
work: its shortest prompt sets the batch's decode steps and its longest
the prompt bucket. A request's text is its prompt's transcript followed by
the drawn phonemes, in the prompt's language. The warm-up batches come from a
stream of their own, so the window's batches do not depend on them.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# a prompt file's lang_code (zh 0, ja 1, en 2) → the model's language id
# (en 0, zh 1, ja 2)
MODEL_LANGUAGE = {0: 1, 1: 2, 2: 0}

GREEDY_BATCHES = 1  # one greedy batch a window, whatever its length

Request = Tuple[np.ndarray, np.ndarray, np.ndarray]  # text ids, lang ids, prompt [Tp, 8]


@dataclass
class Batch:
    index: int
    requests: List[Request]
    greedy: bool  # top_k 1; otherwise the engine's sampling
    seed: int  # the sampler's seed


def load_prompts(root: str, spec: Dict) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    lo, hi = spec["prompt_frames"]
    out = []
    for path in sorted(glob.glob(os.path.join(root, spec["prompts"], "*.npz"))):
        with np.load(path) as d:
            audio = np.asarray(d["audio_tokens"], np.int32).reshape(-1, 8)
            text = np.asarray(d["text_tokens"], np.int32).reshape(-1)
            lang = MODEL_LANGUAGE[int(d["lang_code"])]
        if lo <= len(audio) <= hi:
            out.append((audio, text, lang))
    if not out:
        raise ValueError(f"no prompt of {lo}-{hi} frames under {spec['prompts']}")
    return out


def _seed64(seed: int) -> int:
    return int(seed) % (1 << 64)


class Traffic:
    def __init__(self, spec: Dict, seed: int, root: str, stream: int = 0):
        self.spec = spec
        self.prompts = load_prompts(root, spec)
        ss = np.random.SeedSequence([_seed64(seed), stream])
        self.rng_order, self.rng_text, self.rng_seed = (np.random.default_rng(s)
                                                        for s in ss.spawn(3))
        self._by_length = sorted(range(len(self.prompts)), key=lambda i: len(self.prompts[i][0]))
        self.index = 0

    def _next_prompts(self, n: int) -> List[int]:
        P = len(self.prompts)
        out = []
        for _ in range(n // P):
            out.extend(self.rng_order.permutation(P).tolist())
        r = n % P
        for j in range(r):
            out.append(self._by_length[int(self.rng_order.integers(j * P // r,
                                                                   (j + 1) * P // r))])
        return out

    def next_batch(self) -> Batch:
        s = self.spec
        lo, hi = s["text_phonemes"]
        id_lo, id_hi = s["phoneme_ids"]
        requests = []
        for p in self._next_prompts(s["batch"]):
            audio, text, lang = self.prompts[p]
            n = int(self.rng_text.integers(lo, hi + 1))
            new = self.rng_text.integers(id_lo, id_hi + 1, n).astype(np.int32)
            ids = np.concatenate([text, new])
            requests.append((ids, np.full(len(ids), lang, np.int32), audio))
        b = Batch(self.index, requests, self.index < GREEDY_BATCHES,
                  int(self.rng_seed.integers(0, 2**31 - 1)))
        self.index += 1
        return b


def gen_cap(x_len: int, prompt_len: int, audio_buckets, max_len_ratio: int = 16,
            granularity: int = 512) -> int:
    """A request's generated-frame cap, by the rule the program states for
    one request: min(16·x_len, t_audio − prompt_len − 2), t_audio the
    smallest audio bucket holding prompt + BOS + 16·x_len + EOS (past the
    largest, the next multiple of 512)."""
    want = min(prompt_len + 1 + max_len_ratio * x_len + 1, audio_buckets[-1])
    t_audio: Optional[int] = next((b for b in audio_buckets if want <= b), None)
    if t_audio is None:
        t_audio = -(-want // granularity) * granularity
    return max(0, min(max_len_ratio * x_len, t_audio - prompt_len - 2))
