"""Quantized serving (int8kv, w8a8) in the port against the JAX package's
engine whose Pallas kernels run in interpret mode on the CPU, greedy, in
fp32 at toy width (d 256, 4 heads of 64, 2 layers), K = 4.

One request (B = 1): int8kv codes are equal. w8a8 codes are equal up to
the first step whose greedy pick is a near tie: W8A8 rounds every
activation to an int8 code, round(x / sx), and where x / sx lies on a
half (it does, exactly, now and then), the f32 noise between the two
frameworks (LayerNorm and attention sums in another order, ~1e-7) decides
the code; one code moves a logit by ~5e-3 of its scale. So w8a8 is held
to: equal, or equal for at least 10 frames and the first differing frame
picked where the port's top two logits lie within 1e-2 of the logits'
scale. Several rows (best_of samples of
one request, a batch of requests): the TPU kernels round the score and
spread operands of quantized rows to bf16 when B > 1 (`score16`,
vallex_tpu/ops/decode_block.py:303), a consequence of Mosaic's lane
packing that the port does not copy; so each row is held to the JAX
package's own standard for quantized batched rows
(tests/test_batch_decode.py:196-198): equal for at least its first 10
frames. Slow tier: the Pallas interpreter takes about a minute at this width.
"""

import importlib

import jax
import jax.numpy as jnp
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
from vallex_tpu_torch.ops.decode_step import pack_layer_weights, quantize_weights

pytestmark = pytest.mark.slow  # kernel-interpret tier

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
CFG = ModelConfig(**DIMS)
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
    for S, Tp in ((12, 17), (9, 150)):
        text = rng.randint(5, 100, size=S).astype(np.int32)
        prompt = rng.randint(0, 1024, size=Tp).astype(np.int32)
        reqs.append((text, np.zeros(S, np.int32), prompt))
    return reqs


@pytest.fixture(scope="module")
def model_pair():
    params = JV.init_vallex(jax.random.PRNGKey(11), JModelConfig(**DIMS))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)
    return params, model, quantize_weights(pack_layer_weights(model, torch.float32))


def _engine(params, quantize):
    e = JEngineConfig(text_buckets=(128,), audio_buckets=(512,), compute_dtype="float32",
                      decode_mode="megakernel", decode_steps=K, speculative="off",
                      quantize=quantize)
    return JAR.AREngine(params, JModelConfig(**DIMS), e)


def _interpreted(monkeypatch, fn):
    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    _reload()
    try:
        return fn()
    finally:
        monkeypatch.undo()
        _reload()


def _lead(a, b):
    n = min(len(a), len(b))
    diff = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return int(diff[0]) if len(diff) else n


def _single_port(model, packed, req, quantize, beams=1):
    text, _, prompt = req
    S, Tp = len(text), len(prompt)
    text_pad = np.zeros(128, np.int64)
    text_pad[:S] = text
    prompt_pad = np.full(511, 1024, np.int64)
    prompt_pad[:Tp] = prompt
    res = TAR.ar_generate(
        model, CFG, text_pad, np.zeros(128, np.int64), S, prompt_pad, Tp,
        generator=torch.Generator(), top_k=1, temperature=1.0, gen_limit=None, s_text=128,
        p_audio=512, t_audio=512, dtype=torch.float32, decode_mode="megakernel",
        decode_steps=K, speculative=False, packed=packed, beams=beams, quantize=quantize)
    return res


@pytest.mark.parametrize("quantize", ["int8kv", "w8a8"])
def test_single_request_greedy_matches_pallas_interpret(monkeypatch, model_pair, quantize):
    """B = 1: the codes of the interpreted kernels, every frame (w8a8: up
    to a near tie, module docstring)."""
    params, model, packed = model_pair
    req = _requests()[0]
    want, _ = _interpreted(monkeypatch, lambda: _engine(params, quantize).generate(
        *req, top_k=1, temperature=1.0))
    logits = []
    block = TAR.decode_block_fused

    def recording(*a, **kw):
        r = block(*a, **kw)
        logits.append(r.step_logits[:, :1025])
        return r

    monkeypatch.setattr(TAR, "decode_block_fused", recording)
    res = _single_port(model, packed, req, quantize)
    Tp = len(req[2])
    got = res.tokens[Tp + 1: Tp + 1 + res.gen_len]
    if quantize == "int8kv":
        np.testing.assert_array_equal(got, want)
        return
    lead = _lead(got, want)
    if lead == len(got) == len(want):
        return
    assert lead >= 10
    # frame `lead` was picked from the logits of step lead - 1 (frame 0 from the prefill)
    top2 = torch.topk(torch.cat(logits)[lead - 1], 2).values
    assert float(top2[0] - top2[1]) < 1e-2 * float(torch.cat(logits).abs().max()), lead


@pytest.mark.parametrize("quantize", ["int8kv", "w8a8"])
def test_best_of_and_batch_rows_follow_pallas_interpret(monkeypatch, model_pair, quantize):
    """best_of=3 greedy samples of one request (the port's grouped rows)
    and a batch of 2 requests: every row's codes equal the interpreted
    kernels' for at least 10 frames (score16, module docstring)."""
    params, model, packed = model_pair
    reqs = _requests()

    def jax_runs():
        eng = _engine(params, quantize)
        beams = eng.generate(*reqs[0], best_of=3, top_k=1, temperature=1.0)[0]
        batch = eng.generate_batch(reqs, top_k=1, temperature=1.0)
        return beams, batch

    want_beams, want_batch = _interpreted(monkeypatch, jax_runs)
    res = _single_port(model, packed, reqs[0], quantize, beams=3)
    Tp = len(reqs[0][2])
    assert _lead(res.tokens[Tp + 1: Tp + 1 + res.gen_len], want_beams) >= 10
    pb = TAR.pad_batched_requests(reqs, 1024, 8, (128,), (512,))
    out = TAR.ar_generate_batch(
        model, CFG, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
        pb["prompt_lens"], pb["caps"], generator=torch.Generator(), top_k=1,
        temperature=1.0, s_text=pb["s_text"], p_audio=pb["p_audio"], t_gen=pb["t_gen"],
        dtype=torch.float32, decode_steps=K, packed=packed, quantize=quantize)
    for r, w in enumerate(want_batch):
        assert _lead(out.y_gen[r, : out.gen_len[r]], w) >= 10, f"request {r}"
