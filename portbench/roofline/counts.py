"""Operations and bytes of VALL-E X's work, counted from shapes.

What a result needs, not what a kernel happens to do: a decode step counts
only the rows still generating (a row that has stopped is carried to the
end of its batch but needs nothing), prefill and the NAR only valid
positions and the valid query-key pairs, and each weight is read once a
launch. Every product is 2·K·N operations a row. Vocos counts its
convolutions and products (the inverse FFT is left out: under 1% of them).

A request is (x_len, prompt_len, gen_len): its text phonemes (transcript
included), its prompt frames and the frames generated.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

Request = Tuple[int, int, int]

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def layer_products(D: int, F: int) -> List[Tuple[int, int]]:
    """(K, N) of one encoder layer's four products: QKV, out, FFN up, FFN down."""
    return [(D, 3 * D), (D, D), (D, F), (F, D)]


def dense_flops_per_token(D: int, F: int, NL: int) -> int:
    return 2 * NL * sum(k * n for k, n in layer_products(D, F))


def decode_keys(x_len: int, prompt_len: int, t: int) -> int:
    """Keys a row attends at generated step t: its text, BOS and prompt,
    and the generated columns up to and including its own."""
    return x_len + prompt_len + 1 + t + 1


def ar_prefill_flops(m: Dict, x_len: int, prompt_len: int) -> int:
    D, F, NL, A = m["d_model"], m["ffn_dim"], m["num_layers"], m["num_audio_tokens"]
    n = x_len + prompt_len + 1
    # text rows see the text and BOS; audio row j the text and audio 0..j
    pairs = x_len * (x_len + 1) + sum(x_len + j + 1 for j in range(prompt_len + 1))
    return dense_flops_per_token(D, F, NL) * n + 4 * D * pairs * NL + 2 * D * (A + 1)


def ar_decode_flops(m: Dict, x_len: int, prompt_len: int, gen_len: int) -> int:
    D, F, NL, A = m["d_model"], m["ffn_dim"], m["num_layers"], m["num_audio_tokens"]
    per = dense_flops_per_token(D, F, NL) + 2 * D * (A + 1)
    keys = sum(decode_keys(x_len, prompt_len, t) for t in range(gen_len))
    return per * gen_len + 4 * D * keys * NL


def nar_flops(m: Dict, x_len: int, prompt_len: int, gen_len: int) -> int:
    D, F, NL, A = m["d_model"], m["ffn_dim"], m["num_layers"], m["num_audio_tokens"]
    n = x_len + prompt_len + gen_len
    stage = dense_flops_per_token(D, F, NL) * n + 4 * D * n * n * NL + 2 * D * A * gen_len
    return (m["num_quantizers"] - 1) * stage


def vocos_flops(v: Dict, frames: int) -> int:
    C, Dm, I, L, K = (v["input_channels"], v["dim"], v["intermediate_dim"], v["num_layers"],
                      v["kernel"])
    per = 2 * K * C * Dm + L * (2 * K * Dm + 4 * Dm * I) + 2 * Dm * (v["n_fft"] + 2)
    return per * frames


def request_flops(m: Dict, v: Dict, r: Request) -> int:
    x, p, g = r
    return (ar_prefill_flops(m, x, p) + ar_decode_flops(m, x, p, g) + nar_flops(m, x, p, g)
            + vocos_flops(v, g))


def live_rows(gen_lens: List[int], steps: int) -> List[int]:
    """Rows generating at each of a batch's decode steps."""
    return [sum(1 for g in gen_lens if g > t) for t in range(steps)]


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def gemm_small_m_bound_s(m: Dict, weight_bytes: float, gen_lens: List[int],
                         steps: int) -> float:
    """Least time of a batch's decode products (gemm_small_m: four a layer
    and the head, a launch each a step): the weights once a launch (with
    an f32 scale a column when int8), the live rows' f32 inputs and outputs."""
    D, F, NL, A = m["d_model"], m["ffn_dim"], m["num_layers"], m["num_audio_tokens"]
    shapes = layer_products(D, F) * NL + [(D, A + 1)]
    total = 0.0
    for rows in live_rows(gen_lens, steps):
        for k, n in shapes:
            nbytes = k * n * weight_bytes + (4 * n if weight_bytes == 1 else 0) \
                + 4 * rows * (k + n)
            total += _bound_s(2 * rows * k * n, nbytes)
    return total


def masked_attention_bound_s(m: Dict, kv_bytes: float, requests: List[Request],
                             steps: int) -> float:
    """Least time of a batch's decode attention (a launch a layer a step):
    each live row's valid K and V once, its f32 query and output."""
    D, NL = m["d_model"], m["num_layers"]
    total = 0.0
    for t in range(steps):
        keys = [decode_keys(x, p, t) for x, p, g in requests if g > t]
        if not keys:
            continue
        nbytes = sum(2 * k * D * kv_bytes + 8 * D for k in keys)
        total += NL * _bound_s(4 * D * sum(keys), nbytes)
    return total
