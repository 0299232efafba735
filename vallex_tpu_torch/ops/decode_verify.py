"""One decoder forward over AR positions against the KV cache (port of
vallex_tpu/ops/decode_verify.py::decode_verify, and of the per-step forward
of ops/decode_block.py's batched mode).

`decode_verify` is the bf16 verify pass of speculative decoding: the current
token plus K-1 drafts at positions pos0..pos0+K-1, each attending the valid
cache rows, the pass's earlier positions and itself; it returns the logits
at every position and leaves the K KV columns in the caches. The draft
steps of ops/decode_block.py run the same forward at M = 1, and its batched
mode runs it at M = B, one position per request.

Every product goes through `gemm_small_m`, every attention through
`masked_attention`; only the embedding gather, the PE add and the
cache-column write are PyTorch glue. Caches are [NL, H, C, hd] for one
request or [NL, B, H, C, hd] for B (C with at least K slack rows) and are
updated in place — the TPU kernel returned the columns for an XLA write
instead. Each position's own column is read back from the cache (rounded
to the cache dtype), where the TPU kernel folded it in unrounded; the
own-column mode (`decoder_layers(own_column=True)`, the single steps of
ops/decode_step.py, and always with an int8 cache) folds it in unrounded,
as the TPU kernels do, and the attention kernel writes the column.

Masking contract (engine/ar.py layouts): for one request, cache row c is
valid for the position pos0 + i iff c < x_len or s_text <= c <= s_text +
pos0 + i; for batched requests and their best_of samples see
`decoder_forward`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels import gemm_small_m, masked_attention
from ..kernels.masked_attention import Bounds, attention_bounds


def embed(tokens: torch.Tensor, lw: Dict, pe_rows: torch.Tensor) -> torch.Tensor:
    """[M] tokens → [M, D] f32 decoder input: emb[token] + alpha · PE row."""
    return lw["emb"][tokens.long()].float() + lw["alpha"] * pe_rows


def decoder_forward(
    tokens: torch.Tensor,  # [M] tokens, M = B·Tq (row-major: row b, query qi)
    lw: Dict,  # ops.decode_step.pack_layer_weights (optionally quantized)
    cache_k: torch.Tensor,  # [NL, B, H, C, hd], updated in place
    cache_v: torch.Tensor,
    pe_rows: torch.Tensor,  # [M, D] f32 PE row of every position
    **kw,
) -> torch.Tensor:
    """`decoder_layers` on the embedded tokens → logits [M, VP] f32."""
    return decoder_layers(embed(tokens, lw, pe_rows), lw, cache_k, cache_v, **kw)


def decoder_layers(
    h: torch.Tensor,  # [M, D] f32 decoder input, M = B·Tq
    lw: Dict,
    cache_k: torch.Tensor,  # [NL, B, H, C, hd] (int8 with kv_scales), updated in place
    cache_v: torch.Tensor,
    *,
    slot: Union[int, torch.Tensor],  # cache row of query 0's column (query qi at slot + qi)
    bounds: Bounds,
    site: str,
    prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [NL, R, H, P, hd]
    beams: int = 1,
    attention_site: Optional[str] = None,
    act_quant: bool = False,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [NL, H] f32 each
    own_column: bool = False,
) -> torch.Tensor:
    """→ logits [M, VP] f32. The layer order and the fused LN / bias /
    ReLU / residual epilogues of the TPU kernels' `_attention` and `_ffn`.

    One request (B = 1): Tq consecutive positions. Batched requests
    (engine/ar.py::ar_generate_batch layout, Tq = 1): request b's audio
    position drives its PE row; its new K/V column goes to the generated
    row `slot` = s_text + p_audio + t shared by every request; `bounds`
    (attention_bounds with gen_lo = s_text + p_audio, gen_len = t + 1) let
    it see its own text, its own BOS + prompt rows and the generated rows
    up to `slot`. Grouped best_of samples (B = R·beams request-major rows,
    `prefix` = each request's prefilled text + BOS + prompt K/V): the
    caches hold only generated rows (slot = t, gen_lo = 0), and the
    attention reads row b's prefix from request b // beams. The attention
    launches count under `attention_site` when given.

    act_quant: the W8A8 products (int8 weights, dynamic per-row int8
    activations) for QKV, out-proj and FFN; the head stays W8A16, as in
    the TPU kernels. kv_scales: the int8 KV cache (and prefix) with
    per-(layer, head) scales (engine/ar.py::kv_int8_scales). With an int8
    cache, or own_column, each step's column is folded in unrounded and
    written by the attention kernel (Tq = 1; the walk stops before `slot`).
    `slot` may be a one-element device tensor (Tq = 1): int32 for the
    kernel's write, int64 for the others, which index_copy_ the column
    there, rounded as the host slot's copies round it."""
    M = h.shape[0]
    NL, B, H, _, hd = cache_k.shape
    Tq, D = M // B, H * hd
    own = own_column or kv_scales is not None

    def sc(name, layer):
        s = lw[name]
        return None if s is None else s[layer]

    for li in range(NL):
        qkv = gemm_small_m(
            h, lw["wqkv"][li], scale=sc("sqkv", li), bias=lw["bqkv"][li],
            ln=(lw["ln1s"][li], lw["ln1b"][li]), act_quant=act_quant, site=site,
        )
        heads = qkv.view(B, Tq, 3, H, hd)
        knew, vnew = heads[:, :, 1].transpose(1, 2), heads[:, :, 2].transpose(1, 2)
        if not own and isinstance(slot, torch.Tensor):  # K and V cast once
            kv = heads[:, :, 1:3].to(cache_k.dtype)
            cache_k[li].index_copy_(2, slot.reshape(1), kv[:, :, 0].transpose(1, 2))
            cache_v[li].index_copy_(2, slot.reshape(1), kv[:, :, 1].transpose(1, 2))
        elif not own:
            cache_k[li, :, :, slot: slot + Tq] = knew
            cache_v[li, :, :, slot: slot + Tq] = vnew
        attn = torch.empty((M, D), dtype=torch.float32, device=h.device)
        masked_attention(
            heads[:, :, 0].transpose(1, 2), cache_k[li], cache_v[li], bounds,
            prefix=None if prefix is None else (prefix[0][li], prefix[1][li]),
            beams=beams, out=attn.view(B, Tq, H, hd).transpose(1, 2),
            kv_scales=None if kv_scales is None else (kv_scales[0][li], kv_scales[1][li]),
            new_kv=(knew, vnew) if own else None, slot=slot if own else None,
            site=attention_site or site,
        )
        h = gemm_small_m(attn, lw["wout"][li], scale=sc("sout", li),
                         bias=lw["bout"][li], residual=h, act_quant=act_quant, site=site)
        f = gemm_small_m(h, lw["w1"][li], scale=sc("s1", li), bias=lw["b1"][li],
                         ln=(lw["ln2s"][li], lw["ln2b"][li]), relu=True,
                         act_quant=act_quant, site=site)
        h = gemm_small_m(f, lw["w2"][li], scale=sc("s2", li), bias=lw["b2"][li],
                         residual=h, act_quant=act_quant, site=site)
    return gemm_small_m(h, lw["wpred"], scale=lw["spred"],
                        ln=(lw["fns"], lw["fnb"]), site=site)


def forward_positions(
    tokens: torch.Tensor,  # [M] tokens fed at positions pos0..pos0+M-1
    lw: Dict,
    cache_k: torch.Tensor,  # [NL, H, C, hd], updated in place
    cache_v: torch.Tensor,
    pe_table: torch.Tensor,  # [max_position, D] f32
    *,
    x_len: int,
    audio_pos: int,  # pos0
    s_text: int,
    site: str,
) -> torch.Tensor:
    """One request, M consecutive positions → logits [M, VP] f32."""
    M = tokens.shape[0]
    bounds = attention_bounds(1, x_len=x_len, s_text=s_text, audio_len=audio_pos + 1,
                              q_off=1, device=tokens.device)
    return decoder_forward(
        tokens, lw, cache_k[:, None], cache_v[:, None],
        pe_table[audio_pos: audio_pos + M], slot=s_text + audio_pos,
        bounds=bounds, site=site,
    )


def decode_verify(
    fed: torch.Tensor,  # [K]
    lw: Dict,  # bf16 (not quantized) packed weights
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pe_table: torch.Tensor,
    *,
    x_len: int,
    audio_pos: int,
    s_text: int,
) -> torch.Tensor:
    """One forward over the K fed positions → logits [K, VP] f32; the K
    KV columns are written at s_text + audio_pos (in place)."""
    return forward_positions(
        fed, lw, cache_k, cache_v, pe_table, x_len=x_len,
        audio_pos=audio_pos, s_text=s_text, site="decode_verify",
    )
