"""The port's layers, model functions and kernels' plain versions against
the JAX package, in fp32 on the CPU at toy width.

Tolerance: atol = rtol = 1e-4 on hidden states and logits (fp32 on both
sides; the only differences are summation order). Tokens are compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.models import layers as JL
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.kernels import (
    gemm_small_m,
    masked_attention,
    sample_epilogue,
)
from vallex_tpu_torch.models import vallex as TV

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
D, H, NL, F = 64, 4, 2, 128
JCFG = JModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=F)
CFG = ModelConfig(d_model=D, num_heads=H, num_layers=NL, ffn_dim=F)


@pytest.fixture(scope="module")
def both():
    params = JV.init_vallex(jax.random.PRNGKey(7), JCFG)
    return params, params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(torch_out, jax_out, **tol):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               **(tol or TOL))


def _layer(params, stack, i):
    return jax.tree.map(lambda a: a[i], params[stack]["layers"])


def test_param_tree_round_trip(both):
    params, model = both
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    n_torch = sum(p.numel() for p in model.parameters())
    assert n_jax == n_torch
    np.testing.assert_array_equal(
        model.ar_decoder.layers[1].linear2.w.numpy(),
        np.asarray(params["ar_decoder"]["layers"]["linear2"]["w"][1]))


def test_text_and_audio_input(both):
    params, model = both
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 2048, (1, 9))
    lang = rng.randint(0, 3, (1, 9))
    pe = JL.make_sine_pe(JCFG.max_position, D)
    for stack in ("ar", "nar"):
        j = JV.text_input(params, JCFG, ids, lang, stack, pe)
        t = TV.text_input(model, _t(ids), _t(lang), stack, torch.float32)
        _close(t, j)
    y = rng.randint(0, 1026, (1, 5))
    j = JV.ar_audio_input(params, JCFG, y, pe, 3)
    t = TV.ar_audio_input(model, _t(y), 3, torch.float32)
    _close(t, j)


@pytest.mark.parametrize("adaptive", [False, True])
def test_encoder_layer_apply(both, adaptive):
    params, model = both
    stack = "nar_decoder" if adaptive else "ar_decoder"
    rng = np.random.RandomState(1)
    x = rng.randn(1, 11, D).astype(np.float32)
    emb = rng.randn(D).astype(np.float32) if adaptive else None
    mask = np.where(np.arange(11) < 8, 0.0, -1e9).astype(np.float32)[None, None, None]
    j = JL.encoder_layer_apply(_layer(params, stack, 1), x, H, mask, emb)
    layer = getattr(model, stack).layers[1]
    t = layer(_t(x), _t(mask), None if emb is None else _t(emb))
    _close(t, j)


def test_encoder_layer_prefill(both):
    params, model = both
    rng = np.random.RandomState(2)
    x = rng.randn(1, 10, D).astype(np.float32)
    mask = np.asarray(JV.prefill_mask(jnp.asarray(4), 10))
    jx, jk, jv = JL.encoder_layer_prefill(_layer(params, "ar_decoder", 0), x, H, mask)
    tx, tk, tv = model.ar_decoder.layers[0].prefill(_t(x), _t(mask))
    _close(tx, jx)
    _close(tk, jk)
    _close(tv, jv)


def test_ar_and_nar_logits(both):
    params, model = both
    rng = np.random.RandomState(3)
    h = rng.randn(1, 6, D).astype(np.float32)
    _close(TV.ar_logits(model, _t(h)), JV.ar_logits(params, h))
    _close(TV.nar_logits(model, _t(h), 4), JV.nar_logits(params, h, 4))


def test_nar_forward_stage(both):
    params, model = both
    rng = np.random.RandomState(4)
    xy = rng.randn(1, 12, D).astype(np.float32)
    mask = np.asarray(JV.padding_mask(jnp.asarray([9]), 12))
    j = JV.nar_forward_stage(params, JCFG, xy, 2, mask)
    t = TV.nar_forward_stage(model, _t(xy), 2, _t(mask))
    _close(t, j)


# --- the kernels' plain versions (what the CPU path runs) ---------------------

@pytest.mark.parametrize("wdtype", ["f32", "bf16", "int8"])
def test_gemm_small_m_plain(wdtype):
    """LN → product → scale/bias/ReLU/residual, against the TPU kernel's
    `mat` arithmetic written in jnp (activations cast to bf16 for bf16 and
    int8 weights, f32 accumulation)."""
    rng = np.random.RandomState(5)
    M, K, N = 3, 64, 48
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randn(N, K).astype(np.float32)
    s = (rng.rand(N).astype(np.float32) + 0.5) / 127
    b, r = rng.randn(N).astype(np.float32), rng.randn(M, N).astype(np.float32)
    lns, lnb = rng.randn(K).astype(np.float32), rng.randn(K).astype(np.float32)
    xj = JL.layer_norm_apply({"scale": lns, "bias": lnb}, x)
    if wdtype == "int8":
        wq = np.clip(np.round(w * 20), -127, 127).astype(np.int8)
        wt = torch.from_numpy(wq)
        ref = jax.lax.dot(xj.astype(jnp.bfloat16), wq.T.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32) * s
        scale = _t(s)
    else:
        dt = jnp.bfloat16 if wdtype == "bf16" else jnp.float32
        wt = _t(w).to(torch.bfloat16 if wdtype == "bf16" else torch.float32)
        ref = jax.lax.dot(xj.astype(dt), w.T.astype(dt),
                          preferred_element_type=jnp.float32)
        scale = None
    ref = jnp.maximum(ref + b, 0.0) + r
    t = gemm_small_m(_t(x), wt, scale=scale, bias=_t(b), ln=(_t(lns), _t(lnb)),
                     relu=True, residual=_t(r))
    _close(t, ref)


@pytest.mark.parametrize("Tq,q_off", [(1, 1), (4, 1), (12, 0)])
def test_masked_attention_plain(Tq, q_off):
    """Against jnp attention_core with the engine's additive masks."""
    rng = np.random.RandomState(6)
    s_text, x_len, C, alen = 16, 9, 48, 7
    q = rng.randn(1, H, Tq, 16).astype(np.float32)
    k = rng.randn(1, H, C, 16).astype(np.float32)
    v = rng.randn(1, H, C, 16).astype(np.float32)
    if q_off:
        mask = np.stack([np.asarray(JAR._audio_kv_mask(C, s_text, x_len, alen - 1 + i))[0, 0, 0]
                         for i in range(Tq)])[None, None]
    else:
        cols = np.arange(C)
        ok = np.where(cols < s_text, cols < x_len, cols - s_text < alen)
        mask = np.where(ok, 0.0, -1e9).astype(np.float32)[None, None, None]
    j = JL.attention_core(q, k, v, mask)
    t = masked_attention(_t(q), _t(k), _t(v), x_len=x_len, s_text=s_text,
                         audio_len=alen, q_off=q_off)
    _close(t, j)


@pytest.mark.parametrize("greedy", [True, False])
def test_sample_epilogue_plain(greedy):
    """Gumbel-argmax with the TPU kernel's noise formula, or argmax, and
    the scaled log-softmax of the chosen token."""
    rng = np.random.RandomState(8)
    R, VP, vocab, temp = 3, 40, 33, 0.7
    logits = rng.randn(R, VP).astype(np.float32)
    u = rng.rand(R, VP).astype(np.float32)
    masked = np.where(np.arange(VP) < vocab, logits, -1e30)
    scaled = masked / temp
    score = masked if greedy else scaled - np.log(-np.log(u + 1e-10) + 1e-10)
    tok = np.argmax(score, axis=-1)
    lp = np.asarray(jax.nn.log_softmax(scaled, axis=-1))[np.arange(R), tok]
    tt, tlp = sample_epilogue(_t(logits), None if greedy else _t(u), vocab=vocab,
                              temperature=temp, greedy=greedy)
    np.testing.assert_array_equal(tt.numpy(), tok)
    np.testing.assert_allclose(tlp.numpy(), lp, **TOL)
