"""Benchmark of vallex_tpu_torch (the PyTorch and CUDA port) on NVIDIA GPUs."""
