"""The port's speculative kernel path against the JAX package's Pallas
kernels (decode_block_fused + decode_verify) run in interpret mode on the
CPU, as the JAX package's own kernel tests run them.

Greedy speculative decoding emits exactly the verify pass's argmax, so in
fp32 both sides must emit the same tokens. Slow tier: the Pallas
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
from vallex_tpu_torch.engine.ar import ar_generate
from vallex_tpu_torch.ops.decode_step import pack_layer_weights, quantize_weights

pytestmark = pytest.mark.slow  # kernel-interpret tier

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
JCFG = JModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
CFG = ModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)


def _interpret(monkeypatch):
    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(
        pl_mod, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}),
    )
    from vallex_tpu.ops import decode_block as DB
    from vallex_tpu.ops import decode_step as DS
    from vallex_tpu.ops import decode_verify as DV

    importlib.reload(DS)
    importlib.reload(DB)
    importlib.reload(DV)
    importlib.reload(JAR)


def test_speculative_greedy_matches_pallas_interpret(monkeypatch):
    params = JV.init_vallex(jax.random.PRNGKey(11), JCFG)
    rng = np.random.RandomState(5)
    S, Tp = 12, 20
    text = rng.randint(5, 100, size=S).astype(np.int32)
    prompt = rng.randint(0, 1024, size=Tp).astype(np.int32)
    _interpret(monkeypatch)
    try:
        e = JEngineConfig(text_buckets=(128,), audio_buckets=(512,),
                          compute_dtype="float32", decode_mode="megakernel",
                          decode_steps=8, speculative="on")
        gen, _ = JAR.AREngine(params, JCFG, e).generate(
            text, np.zeros(S, np.int32), prompt, top_k=1, temperature=1.0)
    finally:
        monkeypatch.undo()
        importlib.reload(JAR)

    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)
    packed = pack_layer_weights(model, torch.float32)
    text_pad = np.zeros(128, np.int64)
    text_pad[:S] = text
    prompt_pad = np.full(511, 1024, np.int64)
    prompt_pad[:Tp] = prompt
    res = ar_generate(
        model, CFG, text_pad, np.zeros(128, np.int64), S, prompt_pad, Tp,
        generator=torch.Generator(), top_k=1, temperature=1.0, gen_limit=None,
        s_text=128, p_audio=512, t_audio=512, dtype=torch.float32,
        decode_mode="megakernel", decode_steps=8, speculative=True,
        packed=packed, packed_draft=quantize_weights(packed))
    ours = res.tokens[Tp + 1: Tp + 1 + res.gen_len]
    np.testing.assert_array_equal(ours, gen)
