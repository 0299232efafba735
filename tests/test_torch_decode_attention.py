"""The port's decode_attention (ops/decode_attention.py: the own-column mode
of masked_attention) against the JAX package's Pallas decode_attention run
in interpret mode on the CPU, in fp32; and `decode_mode="pallas"` end to
end against the JAX package's per-token "xla" path.

Op: the same q, new k/v and caches (random, made with numpy from a seed;
rows outside the valid range hold garbage that both sides must skip) at
B = 1 and 2, C = 512, s_text = 128, for three (x_len, audio_pos) pairs.
Output at atol = rtol = 1e-5 (the two sum in another order); the cache
column written at s_text + audio_pos equal to the new k/v (f32 cache), and
every other row untouched. End to end: greedy codes equal, all 8 codebooks.
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
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.ops.decode_attention import decode_attention

torch.set_num_threads(1)

H, HD, C, S_TEXT = 4, 64, 512, 128


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("x_len,audio_pos", [(100, 0), (128, 200), (37, 383)])
def test_decode_attention_matches_jax_kernel(monkeypatch, B, x_len, audio_pos):
    rng = np.random.RandomState(B * 1000 + audio_pos)
    q, nk, nv = (rng.randn(B, H, HD).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(B, H, C, HD).astype(np.float32) for _ in range(2))

    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    from vallex_tpu.ops import decode_attention as DA

    DA = importlib.reload(DA)
    want, jck, jcv = DA.decode_attention(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), DA.pack_cache(jnp.asarray(ck)),
        DA.pack_cache(jnp.asarray(cv)), jnp.asarray(x_len, jnp.int32),
        jnp.asarray(audio_pos, jnp.int32), s_text=S_TEXT)
    monkeypatch.undo()

    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
                           tck, tcv, x_len, audio_pos, s_text=S_TEXT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    slot = S_TEXT + audio_pos
    np.testing.assert_array_equal(tck[:, :, slot].numpy(), nk)
    np.testing.assert_array_equal(tcv[:, :, slot].numpy(), nv)
    # the JAX package's write, unpacked, is the same column
    np.testing.assert_array_equal(np.asarray(jck)[slot].reshape(B, H, HD), nk)
    keep = np.arange(C) != slot
    np.testing.assert_array_equal(tck.numpy()[:, :, keep], ck[:, :, keep])
    np.testing.assert_array_equal(tcv.numpy()[:, :, keep], cv[:, :, keep])


def test_decode_attention_rounds_the_column_to_the_cache_type():
    """A bf16 cache stores the new k/v rounded to bf16 (round to nearest
    even), while the output folds them in unrounded: it differs from
    attending over the rounded column."""
    rng = np.random.RandomState(7)
    q, nk, nv = (torch.from_numpy(rng.randn(1, H, HD).astype(np.float32)) for _ in range(3))
    ck, cv = (torch.from_numpy(rng.randn(1, H, C, HD).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    out = decode_attention(q, nk, nv, ck, cv, 50, 10, s_text=S_TEXT)
    assert torch.equal(ck[:, :, S_TEXT + 10], nk.to(torch.bfloat16))
    assert torch.equal(cv[:, :, S_TEXT + 10], nv.to(torch.bfloat16))
    again = decode_attention(q, ck[:, :, S_TEXT + 10].float(), cv[:, :, S_TEXT + 10].float(),
                             ck.clone(), cv.clone(), 50, 10, s_text=S_TEXT)
    assert not torch.equal(out, again)
    torch.testing.assert_close(out, again, atol=1e-2, rtol=0)


# --- end to end: decode_mode="pallas" ------------------------------------------

TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
BUCKETS = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512),
               compute_dtype="float32")
TEXT, PROMPT = "Hello.", "paimon"


@pytest.fixture(scope="module")
def jax_codes(tmp_path_factory):
    jb = japi.preload_models(
        str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
        cfg=JModelConfig(**TINY), ecfg=JEngineConfig(**BUCKETS, decode_mode="xla"), seed=4)
    audio, text_prompt, lang_pr = japi._load_prompt(PROMPT)
    ids, langs = japi._prepare_text(jb, TEXT, text_prompt, lang_pr, "en")
    codes, _ = jb.pipeline.synthesize(ids, langs, audio, top_k=1)
    return dict(params=jax.tree.map(np.asarray, jb.params),
                vocos=jax.tree.map(np.asarray, jb.vocos_params), codes=codes)


@pytest.mark.parametrize("best_of", [1, 2])
def test_generate_audio_pallas_mode_greedy_matches_jax(jax_codes, best_of):
    """decode_mode="pallas": the model's products and decode_attention per
    layer (its plain version on the CPU); `quantize` has no effect there,
    as in the JAX package. JAX's "xla" greedy codes, all 8 codebooks."""
    bundle = tapi.preload_models(
        params=jax_codes["params"], vocos_params=jax_codes["vocos"], device="cpu",
        cfg=ModelConfig(**TINY),
        ecfg=EngineConfig(**BUCKETS, decode_mode="pallas", quantize="int8kv"))
    assert bundle.pipeline.decode_mode == "pallas"
    tapi.generate_audio(TEXT, prompt=PROMPT, language="en", top_k=1, best_of=best_of)
    res = bundle.last
    np.testing.assert_array_equal(res.codes, jax_codes["codes"])
    assert res.ar.beam_tokens.shape[0] == best_of
