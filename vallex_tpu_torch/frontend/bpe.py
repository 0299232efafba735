"""Pure-Python BPE encoder for HF `tokenizers` JSON files with merges.

The production phoneme vocab (bpe_69) has zero merges and is served by the
dict lookup in tokenizer.py; the reference also ships a 1024-entry BPE with
954 merges (utils/g2p/bpe_1024.json, unused by the default paths but part of
the asset surface). This implements enough of the HF BPE semantics to encode
with such files without the Rust dependency: Whitespace pre-tokenization,
greedy lowest-rank merge loop, unk fallback.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple


class BPETokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 unk_token: str = "[UNK]"):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.unk_id = vocab.get(unk_token, 0)

    @classmethod
    def from_file(cls, path: str) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        merges = [
            tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            for m in model.get("merges", [])
        ]
        unk = model.get("unk_token") or "[UNK]"
        return cls(model["vocab"], merges, unk)

    _pretok_re = re.compile(r"\w+|[^\w\s]+", re.UNICODE)

    def _bpe_word(self, word: str) -> List[str]:
        pieces = list(word)
        while len(pieces) > 1:
            best, best_rank = None, None
            for i in range(len(pieces) - 1):
                r = self.ranks.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            pieces[best : best + 2] = [pieces[best] + pieces[best + 1]]
        return pieces

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._pretok_re.findall(text):
            for piece in self._bpe_word(word):
                ids.append(self.vocab.get(piece, self.unk_id))
        return ids
