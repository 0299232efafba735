"""Where the port runs: `cuda` unless the caller asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless told otherwise; a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to"
            " run the plain PyTorch path on the CPU")
    return dev
