"""VALL-E X in PyTorch for an NVIDIA H100: the port of `vallex_tpu`.

Entry points: `api.generate_audio` (one request), `api.generate_audio_batch`
(R requests as one batched decode) and `server.make_server` (HTTP with
dynamic micro-batching). The AR decode's TPU kernels (`decode_block_fused`,
single and batched, and `decode_verify`) and the NAR's flash attention run
as hand-written CUDA kernels (`kernels/`); the rest is plain PyTorch. Entry points run on
`cuda` unless the caller passes `device="cpu"`, where every kernel wrapper
takes its plain PyTorch version.
"""
