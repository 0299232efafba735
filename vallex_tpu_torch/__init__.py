"""VALL-E X in PyTorch for an NVIDIA H100: the port of `vallex_tpu`.

The AR decode's two TPU kernels (speculative draft `decode_block_fused`
and `decode_verify`) and the NAR's flash attention run as hand-written
CUDA kernels (`kernels/`); the rest is plain PyTorch. Entry points run on
`cuda` unless the caller passes `device="cpu"`, where every kernel wrapper
takes its plain PyTorch version.
"""
