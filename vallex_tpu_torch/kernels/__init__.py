"""Hand-written Hopper kernels (CUDA C++, sm_90a) and their plain versions.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (or raises); `loader.launch_counts` counts the
launches per (kernel, TPU-kernel site), and `loader.launch_seconds` sums
the host time of the wrapper calls that made them.
"""

from .loader import HEAD_DIMS, launch_counts, launch_seconds, reset_launch_counts
from .flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_plain,
)
from .gemm_small_m import gemm_small_m, gemm_small_m_plain
from .masked_attention import masked_attention, masked_attention_plain
from .sample_epilogue import sample_epilogue, sample_epilogue_plain


def check_head_dim(head_dim: int, device) -> None:
    """Raise before any request or step when the model runs on the card at a
    head dim (d_model / num_heads) the attention kernels have no instance
    for; the plain versions on the CPU take any."""
    if str(device).startswith("cuda") and head_dim not in HEAD_DIMS:
        raise ValueError(
            f"head dim {head_dim} (d_model / num_heads) has no attention kernel on the"
            f" card: the kernels are built for head dims {HEAD_DIMS} (ROADMAP.md §3)")

__all__ = [
    "HEAD_DIMS",
    "check_head_dim",
    "launch_counts",
    "launch_seconds",
    "reset_launch_counts",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "gemm_small_m",
    "gemm_small_m_plain",
    "masked_attention",
    "masked_attention_plain",
    "sample_epilogue",
    "sample_epilogue_plain",
]
