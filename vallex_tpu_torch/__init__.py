"""VALL-E X in PyTorch for an NVIDIA H100: the port of `vallex_tpu`.

Entry points: `api.generate_audio` (one request), `api.generate_audio_batch`
(R requests as one batched decode), `server.make_server` (HTTP with
dynamic micro-batching) and, for training, `train.step.train_step` and
`python -m vallex_tpu_torch.train.trainer`. The JAX package's TPU kernels
(the AR decode's, the NAR's flash attention, and training's flash attention
and its backward) run as hand-written CUDA kernels (`kernels/`); the rest
is plain PyTorch. Entry points run on `cuda` unless the caller passes
`device="cpu"`, where every kernel wrapper takes its plain PyTorch version.
"""
