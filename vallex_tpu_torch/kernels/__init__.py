"""Hand-written Hopper kernels (CUDA C++, sm_90a) and their plain versions.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (or raises); `loader.launch_counts` counts the
launches per (kernel, TPU-kernel site).
"""

from .loader import launch_counts, reset_launch_counts
from .gemm_small_m import gemm_small_m, gemm_small_m_plain
from .masked_attention import masked_attention, masked_attention_plain
from .sample_epilogue import sample_epilogue, sample_epilogue_plain

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "gemm_small_m",
    "gemm_small_m_plain",
    "masked_attention",
    "masked_attention_plain",
    "sample_epilogue",
    "sample_epilogue_plain",
]
