"""The port's single-step decode (ops/decode_step.py: decode_step,
decode_step_fused) against the JAX package's Pallas kernels of the same
names, run in interpret mode on the CPU as tests/test_decode_step.py runs
them, in fp32 at toy width (d 256, 4 heads of 64, 2 layers); and
`generate_audio(decode_steps=1)` end to end against the JAX package's
per-token "xla" path.

Both sides get the same weights (the JAX parameter tree, converted), the
same caches and the same inputs, made with numpy from a seed. Tolerances:
logits at 1e-4 of their largest magnitude (the port sums in another
order); greedy tokens equal; logprobs at 1e-5; the written cache column
equal to the new k/v (f32 cache, no rounding). End to end: codes equal,
all 8 codebooks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.models import vallex as JV
from vallex_tpu.ops.decode_attention import pack_cache
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.ops.decode_step import (
    decode_step, decode_step_fused, pack_layer_weights,
)

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
HD = D // H
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
S_TEXT, C = 128, 640  # the TPU kernel wants (C - s_text) % 512 == 0
VOCAB = 1025


@pytest.fixture(scope="module")
def weights():
    """The same AR decoder on both sides: the JAX kernels' packed weights
    and the port's model on the converted tree."""
    params = JV.init_vallex(jax.random.PRNGKey(11), JModelConfig(**DIMS))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=ModelConfig(**DIMS))
    return params, model


def jax_kernels(monkeypatch):
    """vallex_tpu.ops.decode_step with its pallas_call interpreted (a fresh
    module, so no earlier jit trace is reused); the caller undoes."""
    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    from vallex_tpu.ops import decode_step as DS

    return importlib.reload(DS)


def jax_packed(DS, params):
    return DS.pack_layer_weights(
        params["ar_decoder"]["layers"], jnp.float32, final_norm=params["ar_decoder"]["norm"],
        predict_w=params["ar_predict_layer"]["w"],
        audio_embedding=params["ar_audio_embedding"]["weight"])


def step_inputs(B, seed=0):
    """Random caches [NL, B, H, C, hd] (garbage beyond the valid rows, which
    both sides must mask) and a step input x [B, D]."""
    rng = np.random.RandomState(seed)
    ck = rng.randn(NL, B, H, C, HD).astype(np.float32)
    cv = rng.randn(NL, B, H, C, HD).astype(np.float32)
    x = rng.randn(B, D).astype(np.float32)
    return ck, cv, x


def packed_caches(ck, cv):
    return (jnp.stack([pack_cache(jnp.asarray(ck[i])) for i in range(NL)]),
            jnp.stack([pack_cache(jnp.asarray(cv[i])) for i in range(NL)]))


def unpack_column(c, B, slot):
    """[NL, C, B·H·hd] → the column at `slot` as [NL, B, H, hd]."""
    return np.asarray(c)[:, slot].reshape(NL, B, H, HD)


def close(got, want, rel=1e-4):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


CASES = [(1, 100, 3), (1, 128, 200), (3, 100, 3), (3, 128, 200)]
IDS = [f"B{b}-xlen{x}-pos{p}" for b, x, p in CASES]


@pytest.mark.parametrize("B,x_len,pos", CASES, ids=IDS)
def test_decode_step_matches_jax_kernel(weights, monkeypatch, B, x_len, pos):
    """Logits [B, VP] at 1e-4 of their scale; the column written at
    s_text + pos equals the new k/v of both sides."""
    params, model = weights
    ck, cv, x = step_inputs(B)
    DS = jax_kernels(monkeypatch)
    jck, jcv = packed_caches(ck, cv)
    want, jck2, jcv2 = DS.decode_step(
        jnp.asarray(x), jax_packed(DS, params), jck, jcv, jnp.asarray(x_len, jnp.int32),
        jnp.asarray(pos, jnp.int32), s_text=S_TEXT, num_heads=H)
    monkeypatch.undo()
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = decode_step(torch.from_numpy(x), pack_layer_weights(model, torch.float32), tck, tcv,
                      x_len=x_len, audio_pos=pos, s_text=S_TEXT)
    close(got.numpy(), np.asarray(want))
    slot = S_TEXT + pos
    close(tck[:, :, :, slot].numpy(), unpack_column(jck2, B, slot))
    close(tcv[:, :, :, slot].numpy(), unpack_column(jcv2, B, slot))
    # every other row is left as it was
    keep = np.ones(C, bool)
    keep[slot] = False
    np.testing.assert_array_equal(tck.numpy()[:, :, :, keep], ck[:, :, :, keep])


@pytest.mark.parametrize("B,x_len,pos", CASES, ids=IDS)
def test_decode_step_fused_greedy_matches_jax_kernel(weights, monkeypatch, B, x_len, pos):
    """Token in, token out: the greedy next tokens equal, their
    temperature-scaled logprobs at 1e-5."""
    params, model = weights
    ck, cv, _ = step_inputs(B, seed=1)
    tokens = np.random.RandomState(2).randint(0, 1024, size=B).astype(np.int32)
    DS = jax_kernels(monkeypatch)
    jck, jcv = packed_caches(ck, cv)
    alpha = params["ar_audio_position"]["alpha"]
    want_tok, want_lp, _, _ = DS.decode_step_fused(
        jnp.asarray(tokens), jax_packed(DS, params), jck, jcv, jnp.asarray(x_len, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(0, jnp.int32), jnp.asarray(1, jnp.int32),
        jnp.asarray(0.8, jnp.float32), jnp.asarray(alpha, jnp.float32), s_text=S_TEXT,
        num_heads=H, vocab=VOCAB, stochastic=False)
    monkeypatch.undo()
    tok, lp = decode_step_fused(
        torch.from_numpy(tokens), pack_layer_weights(model, torch.float32),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), model.pe, x_len=x_len,
        audio_pos=pos, s_text=S_TEXT, vocab=VOCAB, temperature=0.8, greedy=True)
    assert tok.tolist() == np.asarray(want_tok).tolist()
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-5)


# --- end to end: generate_audio with decode_steps=1 ---------------------------

TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
BUCKETS = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512),
               compute_dtype="float32")
TEXT, PROMPT = "Hello.", "paimon"


@pytest.fixture(scope="module")
def jax_codes(tmp_path_factory):
    """The JAX package's greedy codes on its per-token "xla" path."""
    jb = japi.preload_models(
        str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
        cfg=JModelConfig(**TINY), ecfg=JEngineConfig(**BUCKETS, decode_mode="xla"), seed=4)
    audio, text_prompt, lang_pr = japi._load_prompt(PROMPT)
    ids, langs = japi._prepare_text(jb, TEXT, text_prompt, lang_pr, "en")
    codes, _ = jb.pipeline.synthesize(ids, langs, audio, top_k=1)
    return dict(params=jax.tree.map(np.asarray, jb.params),
                vocos=jax.tree.map(np.asarray, jb.vocos_params), codes=codes)


@pytest.mark.parametrize("kwargs", [dict(), dict(best_of=2), dict(top_p=0.9)],
                         ids=["greedy", "best_of2", "filtered"])
def test_generate_audio_single_step_greedy_matches_jax(jax_codes, kwargs):
    """decode_mode="megakernel" with decode_steps=1 runs the single-step
    ops (their plain versions on the CPU): decode_step_fused for plain
    greedy and its best_of samples, decode_step + topk_sampling for
    top_k=1 with top_p=0.9. One step per frame; JAX's "xla" greedy codes,
    all 8 codebooks."""
    bundle = tapi.preload_models(
        params=jax_codes["params"], vocos_params=jax_codes["vocos"], device="cpu",
        cfg=ModelConfig(**TINY),
        ecfg=EngineConfig(**BUCKETS, decode_mode="megakernel", decode_steps=1))
    tapi.generate_audio(TEXT, prompt=PROMPT, language="en", top_k=1, **kwargs)
    res = bundle.last
    np.testing.assert_array_equal(res.codes, jax_codes["codes"])
    # one step per frame (and one more that feeds EOS, if it came before the cap)
    assert res.ar.iterations - len(res.codes) in (0, 1)
    assert res.ar.beam_tokens.shape[0] == kwargs.get("best_of", 1)
