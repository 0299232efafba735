"""Training dataset and bucketed batching (port of vallex_tpu/data/dataset.py).

An HDF5 dataset of precomputed EnCodec codes and transcripts, a
length-bucketed dynamic batch sampler capped by a token budget, and the
collates, all numpy on the host:
- `collate` pads each batch to a static (text, audio) bucket pair, as the
  JAX package does (the reference pads to the batch maximum); audio pads
  with 0 beside an explicit length array;
- `collate_packed` puts `pack` utterances back to back in each row with
  per-token positions and segment ids (train/loss.py::total_loss_packed);
  its row widths keep the JAX package's 128-multiples, so both packages
  give the same arrays for the same samples;
- `shard` = (process index, process count) slices the sampler's order for
  data parallelism; it is (0, 1) until multi-GPU training is ported.

HDF5 layout (reference-compatible): one group per utterance id holding
"audio" → int codes [8, T]; the annotation file maps
`utt_id|duration|language|text` per line. h5py is imported when a dataset
is opened.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import lang2code, lang2token
from ..frontend import PhonemeTokenizer


@dataclass
class Utterance:
    utt_id: str
    duration: float
    language: str
    text: str


class AudioDataset:
    """HDF5 EnCodec-code dataset (reference: data/dataset.py:131-184)."""

    def __init__(
        self,
        h5_path: str,
        ann_path: str,
        tokenizer: Optional[PhonemeTokenizer] = None,
    ):
        import h5py

        self.h5 = h5py.File(h5_path, "r")
        self.tokenizer = tokenizer or PhonemeTokenizer()
        self.utts: List[Utterance] = []
        with open(ann_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                utt_id, dur, lang, text = line.split("|", 3)
                self.utts.append(
                    Utterance(utt_id, float(dur), lang, text)
                )

    def __len__(self) -> int:
        return len(self.utts)

    def get_dur(self, idx: int) -> float:
        return self.utts[idx].duration

    def __getitem__(self, idx: int) -> Dict:
        u = self.utts[idx]
        codes = np.asarray(self.h5[u.utt_id]["audio"], np.int64)  # [8, T]
        token = lang2token.get(u.language, "[EN]")
        phone_ids, _ = self.tokenizer.tokenize(f"_{token}{u.text}{token}")
        return {
            "utt_id": u.utt_id,
            "text": u.text,
            "language": lang2code.get(u.language, 2),
            "text_tokens": np.asarray(phone_ids, np.int64),
            "audio_features": codes,  # [8, T]
            "audio_features_lens": codes.shape[1],
            "text_tokens_lens": len(phone_ids),
        }


class DynamicBatchSampler:
    """Length-bucketed dynamic batching under a token budget
    (reference: data/dataset.py:48-128)."""

    def __init__(
        self,
        indices_or_sampler,
        num_tokens_fn,
        num_buckets: int = 100,
        min_size: int = 0,
        max_size: int = 1000,
        max_tokens: Optional[int] = None,
        max_sentences: Optional[int] = None,
        drop_last: bool = False,
        shuffle: bool = True,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),  # (process_index, process_count)
    ):
        assert max_tokens is not None or max_sentences is not None
        if max_tokens is not None:
            assert max_size <= max_tokens
        self.indices = list(indices_or_sampler)
        self.num_tokens_fn = num_tokens_fn
        self.num_buckets = num_buckets
        self.min_size = min_size
        self.max_size = max_size
        self.max_tokens = max_tokens if max_tokens is not None else math.inf
        self.max_sentences = (
            max_sentences if max_sentences is not None else math.inf
        )
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.shard = shard

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _is_full(self, num_tokens: float, batch: List[int]) -> bool:
        if not batch:
            return False
        return len(batch) == self.max_sentences or num_tokens > self.max_tokens

    def __iter__(self) -> Iterator[List[int]]:
        order = list(self.indices)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        rank, world = self.shard
        order = order[rank::world]

        buckets: List[List[int]] = [[] for _ in range(self.num_buckets)]
        bucket_len = [0.0] * self.num_buckets
        for idx in order:
            n = self.num_tokens_fn(idx)
            if not (self.min_size <= n <= self.max_size):
                continue
            b = math.floor(
                (n - self.min_size)
                / (self.max_size - self.min_size + 1)
                * self.num_buckets
            )
            bucket_len[b] = max(bucket_len[b], n)
            total = (len(buckets[b]) + 1) * bucket_len[b]
            if self._is_full(total, buckets[b]):
                yield buckets[b]
                buckets[b] = []
                bucket_len[b] = 0.0
            buckets[b].append(idx)

        leftover = [i for b in buckets for i in b]
        batch: List[int] = []
        blen = 0.0
        for idx in leftover:
            blen = max(blen, self.num_tokens_fn(idx))
            if self._is_full((len(batch) + 1) * blen, batch):
                yield batch
                batch = []
                blen = self.num_tokens_fn(idx)
            batch.append(idx)
        if batch and not self.drop_last:
            yield batch


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def collate(
    samples: List[Dict],
    text_buckets: Sequence[int] = (64, 128, 256),
    audio_buckets: Sequence[int] = (256, 512, 1024, 2048),
) -> Dict[str, np.ndarray]:
    """Pad a batch to static bucket shapes → arrays ready for train_step."""
    B = len(samples)
    S = _bucket(max(s["text_tokens_lens"] for s in samples), text_buckets)
    T = _bucket(max(s["audio_features_lens"] for s in samples), audio_buckets)

    text_ids = np.full((B, S), 3, np.int32)  # [PAD] id 3 (reference collate)
    lang_ids = np.zeros((B, S), np.int32)
    text_lens = np.zeros((B,), np.int32)
    codes = np.zeros((B, T, 8), np.int32)
    audio_lens = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        sl = min(s["text_tokens_lens"], S)
        al = min(s["audio_features_lens"], T)
        text_ids[i, :sl] = s["text_tokens"][:sl]
        lang_ids[i, :] = s["language"]
        text_lens[i] = sl
        codes[i, :al] = s["audio_features"][:, :al].T
        audio_lens[i] = al
    return {
        "utt_ids": [s["utt_id"] for s in samples],
        "text_ids": text_ids,
        "lang_ids": lang_ids,
        "text_lens": text_lens,
        "codes": codes,
        "audio_lens": audio_lens,
    }


def _ceil128(n: int) -> int:
    return -(-n // 128) * 128


def _flash_friendly(total: int) -> int:
    """Smallest multiple of 128 ≥ total whose 128-block count divides by
    2, 3 or 4: the JAX package's row width for its Pallas blocks, kept so
    both packages pack to the same arrays."""
    n = _ceil128(total)
    while (n // 128) % 4 and (n // 128) % 3 and (n // 128) % 2:
        n += 128
    return n


def collate_packed(
    samples: List[Dict],
    pack: int = 2,
    text_buckets: Sequence[int] = (64, 128, 256),
    audio_buckets: Sequence[int] = (256, 512, 1024, 2048),
) -> Dict[str, np.ndarray]:
    """Sequence-PACKED collate: `pack` utterances share each batch row,
    back-to-back, with per-token position ids (PE restarts per utterance)
    and per-token segment ids (flash segment masks keep attention within
    each utterance). Short utterances stop paying the static bucket's
    padded FLOPs: the row width is set by the PACKED length distribution
    (max over rows of Σ lens), not `pack`× the longest utterance —
    utterances are paired longest-with-shortest to balance rows.

    → dict with the packed per-token arrays (p_*) consumed by
    train/loss.py::total_loss_packed, plus audio_lens (real per-utterance
    lengths — the NAR prefix sampler and real-frames/s accounting use
    them).
    """
    order = sorted(
        range(len(samples)), key=lambda i: samples[i]["audio_features_lens"]
    )
    # longest-with-shortest pairing: row r takes one from each end per slot
    rows: List[List[Dict]] = []
    lo, hi = 0, len(order) - 1
    while lo <= hi:
        row = []
        for k in range(pack):
            if lo > hi:
                break
            idx = order[hi] if k % 2 == 0 else order[lo]
            if k % 2 == 0:
                hi -= 1
            else:
                lo += 1
            row.append(samples[idx])
        rows.append(row)
    B = len(rows)

    # row widths: audio needs len+1 slots per utterance (BOS prepend);
    # text needs its own region. Both padded as the JAX package pads them.
    Ws = _ceil128(max(sum(s["text_tokens_lens"] for s in r) for r in rows))
    wa_need = max(sum(s["audio_features_lens"] + 1 for s in r) for r in rows)
    Wa = _flash_friendly(Ws + _ceil128(wa_need)) - Ws

    p_text_ids = np.full((B, Ws), 3, np.int32)  # [PAD] id 3
    p_lang_ids = np.zeros((B, Ws), np.int32)
    p_text_pos = np.zeros((B, Ws), np.int32)
    p_text_seg = np.zeros((B, Ws), np.int32)
    p_audio_in = np.zeros((B, Wa), np.int32)
    p_audio_pos = np.zeros((B, Wa), np.int32)
    p_audio_seg = np.zeros((B, Wa), np.int32)
    p_targets = np.zeros((B, Wa), np.int32)
    p_loss_mask = np.zeros((B, Wa), np.float32)
    p_codes = np.zeros((B, Wa, 8), np.int32)
    p_codes_pos = np.zeros((B, Wa), np.int32)
    p_codes_seg = np.zeros((B, Wa), np.int32)
    audio_lens = np.zeros((len(samples),), np.int32)
    utt_ids = []

    BOS, EOS = 1025, 1024
    u = 0
    for r, row in enumerate(rows):
        ts = 0  # text cursor
        au = 0  # audio cursor (AR region, len+1 per utterance)
        cu = 0  # codes cursor (NAR region, len per utterance)
        for k, s in enumerate(row):
            sl = s["text_tokens_lens"]
            al = s["audio_features_lens"]
            seg_id = k + 1
            p_text_ids[r, ts : ts + sl] = s["text_tokens"][:sl]
            p_lang_ids[r, ts : ts + sl] = s["language"]
            p_text_pos[r, ts : ts + sl] = np.arange(sl)
            p_text_seg[r, ts : ts + sl] = seg_id
            ts += sl
            cb = s["audio_features"][:, :al].T  # [al, 8]
            # AR: inputs [BOS, y], targets [y, EOS], loss over len+1
            p_audio_in[r, au] = BOS
            p_audio_in[r, au + 1 : au + 1 + al] = cb[:, 0]
            p_audio_pos[r, au : au + al + 1] = np.arange(al + 1)
            p_audio_seg[r, au : au + al + 1] = seg_id
            p_targets[r, au : au + al] = cb[:, 0]
            p_targets[r, au + al] = EOS
            p_loss_mask[r, au : au + al + 1] = 1.0
            au += al + 1
            # NAR: packed codes with per-utterance positions
            p_codes[r, cu : cu + al] = cb
            p_codes_pos[r, cu : cu + al] = np.arange(al)
            p_codes_seg[r, cu : cu + al] = seg_id
            cu += al
            audio_lens[u] = al
            utt_ids.append(s["utt_id"])
            u += 1
    return {
        "utt_ids": utt_ids,
        "p_text_ids": p_text_ids,
        "p_lang_ids": p_lang_ids,
        "p_text_pos": p_text_pos,
        "p_text_seg": p_text_seg,
        "p_audio_in": p_audio_in,
        "p_audio_pos": p_audio_pos,
        "p_audio_seg": p_audio_seg,
        "p_targets": p_targets,
        "p_loss_mask": p_loss_mask,
        "p_codes": p_codes,
        "p_codes_pos": p_codes_pos,
        "p_codes_seg": p_codes_seg,
        "audio_lens": audio_lens,
    }


def create_dataloader(
    h5_path: str,
    ann_path: str,
    *,
    max_duration: float = 120.0,
    max_size: float = 20.0,
    num_buckets: int = 10,
    shuffle: bool = True,
    seed: int = 0,
    shard: Tuple[int, int] = (0, 1),
    pack: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Generator of collated batches (reference: data/dataset.py:225-242).
    pack > 1 emits sequence-packed batches (collate_packed) for
    train_step(packed=True) when the batch holds at least 2·pack
    utterances; smaller batches come unpacked."""
    ds = AudioDataset(h5_path, ann_path)
    sampler = DynamicBatchSampler(
        range(len(ds)), ds.get_dur,
        num_buckets=num_buckets, max_size=max_size,
        max_tokens=max_duration, shuffle=shuffle, seed=seed, shard=shard,
    )
    for batch_idx in sampler:
        samples = [ds[i] for i in batch_idx]
        if pack > 1 and len(samples) >= 2 * pack:
            yield collate_packed(samples, pack=pack)
        else:
            yield collate(samples)
