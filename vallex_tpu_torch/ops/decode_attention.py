"""Single-query decode attention for one layer (port of
vallex_tpu/ops/decode_attention.py::decode_attention, the attention of
decode_mode="pallas").

The TPU kernel walks the valid blocks of a lane-packed [C, B·H·hd] cache,
folds this step's own k/v into the softmax unrounded, and leaves the cache
column to an XLA write. Here it is the own-column mode of the
`masked_attention` kernel on the port's [B, H, C, hd] cache: the walk
covers the text rows < x_len and the audio rows s_text <= c < s_text +
audio_pos, the new k/v are folded in, and the kernel writes them into the
slot s_text + audio_pos, rounded to the cache type.
"""

from __future__ import annotations

import torch

from ..kernels import masked_attention
from ..kernels.masked_attention import attention_bounds

SITE = "decode_attention"


def decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    new_k: torch.Tensor,  # [B, H, hd]
    new_v: torch.Tensor,  # [B, H, hd]
    cache_k: torch.Tensor,  # [B, H, C, hd], the column is written in place
    cache_v: torch.Tensor,
    x_len,  # valid text rows: int, or [B]
    audio_pos: int,
    *,
    s_text: int,
) -> torch.Tensor:
    """→ attended [B, H, hd] in q's dtype (f32 inside); cache row
    s_text + audio_pos of cache_k/v ← new_k/v."""
    B = q.shape[0]
    bounds = attention_bounds(B, x_len=x_len, s_text=s_text, audio_len=audio_pos, q_off=0,
                              device=q.device)
    out = masked_attention(
        q.float()[:, :, None], cache_k, cache_v, bounds,
        new_kv=(new_k.float()[:, :, None], new_v.float()[:, :, None]),
        slot=s_text + audio_pos, site=SITE,
    )
    return out[:, :, 0].to(q.dtype)
