"""The check that decides `correct`: what the timed path returned, held
against the plain reference (portbench/reference/).

Every request of the window is checked for its shape: codes [G, 8] in
range with G at most the request's cap, and a finite wave of G · 320
samples. A sample of requests drawn from the seed, with the longest in it,
is run through the reference, teacher-forced on the served tokens:
- `ar_gap`: over the greedy requests, the widest gap by which a served
  codebook-0 token's logit (and the EOS's, where the request stopped
  before its cap) lies below the reference's best logit at its position;
- `nar_mean_gap`: the mean gap of the served codebooks 1..7 below the
  reference's best, over every generated row of every sampled request at
  each of the NAR's stages (the widest NAR gap does not separate the
  program, bf16 throughout, from an int8 control: PERF.md);
- `wave_err`: the largest ‖wave − reference wave‖ / ‖reference wave‖.
The control (`control`) reads the same numbers for the reference in a
lower precision: the gap of the token that it puts first, and its wave.
The model's reference is the architecture's (portbench/archs/), Vocos's
reference/vocos.py.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..reference import vocos as RVoc
from ..reference.quant import Precision
from .traffic import gen_cap

HOP = 320
AUDIO_CODES = 1024
N_GREEDY = 12  # greedy requests a run judges through the reference, the longest first
N_SAMPLED = 4  # sampled requests a run judges (their NAR codes and waves)


@dataclass
class Item:
    """One request to judge: its inputs and what the program returned."""
    text: np.ndarray
    lang: np.ndarray
    prompt: np.ndarray  # [Tp, 8]
    codes: np.ndarray  # [G, 8]
    wave: np.ndarray  # [G · 320]
    cap: int
    greedy: bool


@contextlib.contextmanager
def strict_float32():
    """TF32 off for the reference's products and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def shape_ok(codes, wave, cap: int) -> bool:
    codes = np.asarray(codes)
    if codes.ndim != 2 or codes.shape[1] != 8 or not 0 <= len(codes) <= cap:
        return False
    if len(codes) and (codes.min() < 0 or codes.max() >= AUDIO_CODES):
        return False
    return wave is not None and len(wave) == len(codes) * HOP and bool(np.isfinite(wave).all())


def items_of(batch, outputs, buckets) -> Tuple[List[Item], int]:
    """The batch's requests as Items, and how many came back malformed
    (or not at all)."""
    items, failed = [], 0
    for r, (text, lang, prompt) in enumerate(batch.requests):
        cap = gen_cap(len(text), len(prompt), buckets)
        if r >= len(outputs) or not shape_ok(*outputs[r], cap):
            failed += 1
            continue
        codes, wave = outputs[r]
        items.append(Item(text, lang, prompt, np.asarray(codes), np.asarray(wave), cap,
                          batch.greedy))
    return items, failed


def sample(items: List[Item], seed: int, n_greedy: int = N_GREEDY,
           n_sampled: int = N_SAMPLED) -> List[Item]:
    """n_greedy greedy requests (the longest first) and n_sampled others
    (the longest first), drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    out = []
    for want, pool in ((n_greedy, [i for i in items if i.greedy]),
                       (n_sampled, [i for i in items if not i.greedy])):
        if not pool or want <= 0:
            continue
        longest = max(range(len(pool)), key=lambda k: len(pool[k].codes))
        rest = [k for k in range(len(pool)) if k != longest]
        pick = [longest] + rng.permutation(rest)[: want - 1].tolist()
        out.extend(pool[k] for k in pick)
    return out


def _gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap of the tokens' reference logits below each row's best."""
    if len(tokens) == 0:
        return 0.0
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    return float((best - got).max())


def _gap_sum(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    best = ref_logits.max(dim=-1).values
    return float((best - ref_logits.gather(1, tokens[:, None].long())[:, 0]).sum())


@torch.inference_mode()
def readings(model, vocos: RVoc.Vocos, items: List[Item],
             control: Optional[Dict] = None) -> Dict[str, Dict[str, float]]:
    """{"program": {number: reading}} and, with a control, {"control": ...}.
    `model`: the architecture's `reference(tree, model)`."""
    dev = model.device
    prog = {"ar_gap": 0.0, "nar_mean_gap": 0.0, "wave_err": 0.0}
    ctrl = dict(prog)
    nar_sum = {"program": 0.0, "control": 0.0}
    nar_tokens = 0
    low_ar = low_nar = None
    if control is not None:
        low_ar, low_nar = Precision(**control["ar"]), Precision(**control["nar"])
        low_wave = getattr(torch, control["vocos_dtype"])
    with strict_float32():
        for it in items:
            t = lambda a: torch.as_tensor(np.asarray(a), device=dev).long()  # noqa: E731
            text, lang, prompt, codes = t(it.text), t(it.lang), t(it.prompt), t(it.codes)
            G, Tp = len(codes), len(prompt)
            if it.greedy:
                args = (text, lang, prompt[:, 0], codes[:, 0])
                ref = model.ar_logits(*args)
                served = codes[:, 0]
                rows = ref[:G]
                if G < it.cap:  # stopped early: the EOS it served counts
                    served = torch.cat([served, served.new_tensor([model.eos])])
                    rows = ref[: G + 1]
                prog["ar_gap"] = max(prog["ar_gap"], _gap(rows, served))
                if control is not None:
                    low = model.ar_logits(*args, prec=low_ar)[: len(rows)]
                    ctrl["ar_gap"] = max(ctrl["ar_gap"], _gap(rows, low.argmax(-1)))
            if G:
                full = torch.cat([prompt, codes])
                ref = model.nar_logits(text, lang, full, Tp)
                low = (model.nar_logits(text, lang, full, Tp, prec=low_nar)
                       if control is not None else None)
                for s, rl in enumerate(ref):
                    nar_sum["program"] += _gap_sum(rl, codes[:, s + 1])
                    if low is not None:
                        nar_sum["control"] += _gap_sum(rl, low[s].argmax(-1))
                    nar_tokens += G
                wref = vocos.wave(codes)
                norm = float(wref.norm()) or 1.0
                w = torch.as_tensor(it.wave, device=dev).float()
                prog["wave_err"] = max(prog["wave_err"], float((w - wref).norm()) / norm)
                if control is not None:
                    wl = vocos.wave(codes, dtype=low_wave)
                    ctrl["wave_err"] = max(ctrl["wave_err"], float((wl - wref).norm()) / norm)
    if nar_tokens:
        prog["nar_mean_gap"] = nar_sum["program"] / nar_tokens
        ctrl["nar_mean_gap"] = nar_sum["control"] / nar_tokens
    out = {"program": prog}
    if control is not None:
        out["control"] = ctrl
    return out
