"""The port's batched greedy decode (engine/ar.py::ar_generate_batch)
against the JAX package's ar_generate_batch, whose batched
decode_block_fused Pallas kernel runs in interpret mode on the CPU, as the
JAX package's own tests/test_batch_decode.py runs it.

Greedy tokens must be identical per request in fp32. Slow tier: the Pallas
interpreter takes minutes at this width.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.engine import ar as TAR
from vallex_tpu_torch.ops.decode_step import pack_layer_weights

pytestmark = pytest.mark.slow  # kernel-interpret tier

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
K = 4


def _reload():
    from vallex_tpu.ops import decode_block as DB
    from vallex_tpu.ops import decode_step as DS
    from vallex_tpu.ops import decode_verify as DV

    importlib.reload(DS)
    importlib.reload(DB)
    importlib.reload(DV)
    importlib.reload(JAR)


def _requests():
    rng = np.random.RandomState(5)
    reqs = []
    for S, Tp in ((12, 17), (9, 150), (14, 0)):
        text = rng.randint(5, 100, size=S).astype(np.int32)
        prompt = rng.randint(0, 1024, size=Tp).astype(np.int32) if Tp else None
        reqs.append((text, np.zeros(S, np.int32), prompt))
    return reqs


def test_batch_greedy_matches_pallas_interpret(monkeypatch):
    params = JV.init_vallex(jax.random.PRNGKey(11), JModelConfig(**DIMS))
    reqs = _requests()
    e = JEngineConfig(text_buckets=(128,), audio_buckets=(512,), compute_dtype="float32",
                      decode_mode="megakernel", decode_steps=K, speculative="off")
    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    _reload()
    try:
        want = JAR.AREngine(params, JModelConfig(**DIMS), e).generate_batch(
            reqs, top_k=1, temperature=1.0, seed=3)
    finally:
        monkeypatch.undo()
        _reload()

    cfg = ModelConfig(**DIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=cfg)
    pb = TAR.pad_batched_requests(reqs, cfg.eos_id, 8, (128,), (512,))
    res = TAR.ar_generate_batch(
        model, cfg, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
        pb["prompt_lens"], pb["caps"], generator=torch.Generator(), top_k=1,
        temperature=1.0, s_text=pb["s_text"], p_audio=pb["p_audio"], t_gen=pb["t_gen"],
        dtype=torch.float32, decode_steps=K, packed=pack_layer_weights(model, torch.float32))
    for r, w in enumerate(want):
        np.testing.assert_array_equal(res.y_gen[r, : res.gen_len[r]], w,
                                      err_msg=f"request {r}")
