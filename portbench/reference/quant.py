"""Symmetric fake quantization for the control: the reference computed in a
lower precision than the configuration states.

`Precision()` is plain float32. `weight_bits` rounds every product's
weights per output column, `kv_bits` each layer's K and V per head, and
`act_bits` every activation the program keeps in its own type between
operations (each product's input, the attention's queries, the residual
stream at each layer's input and after each residual add) per row, to the
integers in [-(2^(b-1) - 1), 2^(b-1) - 1] times a scale of (largest
magnitude) / (2^(b-1) - 1), and multiplies back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def fake_quant(x: torch.Tensor, bits: int, dims) -> torch.Tensor:
    """Round x to `bits`-bit symmetric integers, one scale per slice over
    `dims` (the dims reduced for the largest magnitude)."""
    top = float(2 ** (bits - 1) - 1)
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / top
    return torch.clamp(torch.round(x / scale), -top, top) * scale


@dataclass(frozen=True)
class Precision:
    weight_bits: Optional[int] = None
    kv_bits: Optional[int] = None
    act_bits: Optional[int] = None

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A [in, out] weight, per output column."""
        return w if self.weight_bits is None else fake_quant(w, self.weight_bits, dims=-2)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A [.., features] activation, per row."""
        return x if self.act_bits is None else fake_quant(x, self.act_bits, dims=-1)

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        """A [H, T, hd] key or value block, per head."""
        return x if self.kv_bits is None else fake_quant(x, self.kv_bits, dims=(-2, -1))

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.weight(w)


FLOAT32 = Precision()
