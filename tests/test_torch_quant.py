"""Quantized serving in the port: the int8 KV cache (`quantize="int8kv"`)
and W8A8 products (`quantize="w8a8"`), against the JAX package on the CPU
in fp32 at toy width (d 256, 4 heads of 64, 2 layers).

- kv_int8_scales / kv_int8_quantize against JAX's _kv_int8_scales /
  _kv_int8_quantize on the same prefilled caches (one request; a batch of
  3; the grouped prefix of 3), in f32 and bf16: scales at rtol 1e-7, int8
  values equal.
- The W8A8 decode_step and the int8kv and w8a8 K-step blocks (plain
  versions) against the JAX Pallas kernels run in interpret mode: fed
  tokens equal, logits at 1e-4 of their largest magnitude.
- Every route end to end at toy width (d 64): one request, best_of=3 and
  a batch of 2, in both modes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.models import vallex as JV
from vallex_tpu.ops.decode_attention import pack_cache
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.engine import ar as TAR
from vallex_tpu_torch.ops.decode_block import decode_block_fused
from vallex_tpu_torch.ops.decode_step import decode_step, pack_layer_weights, quantize_weights

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
HD = D // H
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
CFG = ModelConfig(**DIMS)
EOS, VOCAB = 1024, 1025
S_TEXT, T_AUDIO = 128, 512


@pytest.fixture(scope="module")
def weights():
    params = JV.init_vallex(jax.random.PRNGKey(11), JModelConfig(**DIMS))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)
    return params, model


def _requests():
    rng = np.random.RandomState(5)
    reqs = []
    for S, Tp in ((12, 17), (9, 150), (14, 0)):
        text = rng.randint(5, 100, size=S).astype(np.int32)
        prompt = rng.randint(0, 1024, size=Tp).astype(np.int32) if Tp else None
        reqs.append((text, np.zeros(S, np.int32), prompt))
    return reqs


def _prefill(model, layout, dtype):
    """The port's prefill of the three requests (or the first alone) →
    (cache_k, cache_v [NL, R, H, C, hd], logits0, padded batch)."""
    reqs = _requests()[:1] if layout == "single" else _requests()
    pb = TAR.pad_batched_requests(reqs, EOS, 8, (S_TEXT,), (T_AUDIO,))
    R, P = len(reqs), pb["s_text"] + pb["p_audio"]
    C = {"single": S_TEXT + T_AUDIO + 8, "batched": P + pb["t_gen"] + 8, "grouped": P}[layout]
    y_init = torch.cat([torch.full((R, 1), 1025, dtype=torch.int64),
                        torch.as_tensor(pb["prompt_pad"]).long()], dim=1)
    ck, cv, logits0 = TAR.prefill(
        model, CFG, torch.as_tensor(pb["text"]), torch.as_tensor(pb["lang"]),
        torch.as_tensor(pb["x_lens"]), y_init, torch.as_tensor(pb["prompt_lens"]),
        s_text=pb["s_text"], p_audio=pb["p_audio"], C=C, dtype=dtype)
    return ck, cv, logits0, pb


def _lane_packed(cache: torch.Tensor):
    """The port's [NL, R, H, C, hd] → the JAX kernels' [NL, C, R·H·hd]."""
    c = jnp.asarray(cache.float().numpy())
    if cache.dtype == torch.bfloat16:
        c = c.astype(jnp.bfloat16)  # exact: the values are bf16
    return jnp.stack([pack_cache(c[i]) for i in range(c.shape[0])])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["single", "batched", "grouped"])
def test_kv_int8_scales_and_quantize_match_jax(weights, layout, dtype):
    """Scales per (layer, head), taken over every row of every request of
    the batch (batch-wide, as JAX), and the quantized caches."""
    _, model = weights
    ck, _, _, _ = _prefill(model, layout, dtype)
    R = ck.shape[1]
    jc = _lane_packed(ck)
    lanes = JAR._kv_int8_scales(jc, H, HD)  # [NL, 1, R·H·hd]
    want = np.asarray(lanes).reshape(NL, R, H, HD)
    assert (want == want[:, :1, :, :1]).all()  # one scale per (layer, head)
    got = TAR.kv_int8_scales(ck)
    assert got.shape == (NL, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:, 0, :, 0], rtol=1e-7, atol=0)
    q = TAR.kv_int8_quantize(ck, got)
    jq = np.asarray(JAR._kv_int8_quantize(jc, lanes))  # [NL, C, R·H·hd]
    jq = jq.reshape(NL, -1, R, H, HD).transpose(0, 2, 3, 1, 4)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), jq)
    assert np.abs(jq).max() == 106  # each head's largest prefill value: round(127 / 1.2)


def test_kv_int8_scales_are_batch_wide(weights):
    """A request alone gets other scales than within the batch: the
    maximum runs over every request (vallex_tpu/engine/ar.py:248-250)."""
    _, model = weights
    ck, _, _, _ = _prefill(model, "batched", torch.float32)
    batch = TAR.kv_int8_scales(ck)
    alone = torch.stack([TAR.kv_int8_scales(ck[:, r:r + 1]) for r in range(3)])
    torch.testing.assert_close(batch, alone.amax(0), rtol=0, atol=0)
    assert (alone < batch).any()


def _jax_kernels(monkeypatch):
    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    from vallex_tpu.ops import decode_block as DB
    from vallex_tpu.ops import decode_step as DS

    return importlib.reload(DS), importlib.reload(DB)


def _jax_packed(DS, params):
    lw = DS.pack_layer_weights(
        params["ar_decoder"]["layers"], jnp.float32, final_norm=params["ar_decoder"]["norm"],
        predict_w=params["ar_predict_layer"]["w"],
        audio_embedding=params["ar_audio_embedding"]["weight"])
    return DS.quantize_weights(lw)


def close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def test_decode_step_w8a8_matches_jax_kernel(weights, monkeypatch):
    """W8A8 products (int8 weights, dynamic per-row int8 activations; the
    head W8A16) in one step at B = 1, against decode_step(quant=True,
    act_quant=True): logits at 1e-4 of their scale."""
    params, model = weights
    rng = np.random.RandomState(3)
    C = S_TEXT + T_AUDIO
    ck, cv = (rng.randn(NL, 1, H, C, HD).astype(np.float32) for _ in range(2))
    x = rng.randn(1, D).astype(np.float32)
    DS, _ = _jax_kernels(monkeypatch)
    want, _, _ = DS.decode_step(
        jnp.asarray(x), _jax_packed(DS, params), _lane_packed(torch.from_numpy(ck)),
        _lane_packed(torch.from_numpy(cv)), jnp.asarray(100, jnp.int32),
        jnp.asarray(200, jnp.int32), s_text=S_TEXT, num_heads=H, quant=True, act_quant=True)
    monkeypatch.undo()
    lw = quantize_weights(pack_layer_weights(model, torch.float32))
    got = decode_step(torch.from_numpy(x), lw, torch.from_numpy(ck), torch.from_numpy(cv),
                      x_len=100, audio_pos=200, s_text=S_TEXT, act_quant=True)
    close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["int8kv", "w8a8"])
def test_quantized_block_matches_jax_kernel(weights, monkeypatch, mode):
    """One K-step block of 4 greedy steps at B = 1 from the same prefill:
    int8kv (int8 weights, int8 caches quantized by each side's own
    functions, own column unrounded in cache units) against
    decode_block_fused(kv_scales=...), w8a8 against act_quant=True. Fed
    tokens and the next token equal, every step's logits at 1e-4 of their
    scale; int8kv: the 4 quantized columns the blocks wrote agree (a
    column value on a rounding boundary may differ by one)."""
    params, model = weights
    ck, cv, logits0, pb = _prefill(model, "single", torch.float32)
    x_len, plen = int(pb["x_lens"][0]), int(pb["prompt_lens"][0])
    tok0 = int(logits0[0].argmax())
    steps, pos0 = 4, plen + 1
    kv = mode == "int8kv"
    DS, DB = _jax_kernels(monkeypatch)
    jck, jcv = _lane_packed(ck), _lane_packed(cv)
    kv_scales = None
    if kv:
        kl, vl = JAR._kv_int8_scales(jck, H, HD), JAR._kv_int8_scales(jcv, H, HD)
        jck, jcv = JAR._kv_int8_quantize(jck, kl), JAR._kv_int8_quantize(jcv, vl)
        kv_scales = (kl, vl)
    one = lambda v, t: jnp.asarray([v], t)  # noqa: E731
    ytok, nxt, _, _, _, jck2, _, jlogits = DB.decode_block_fused(
        one(tok0, jnp.int32), one(0.0, jnp.float32), one(False, bool), one(0.0, jnp.float32),
        _jax_packed(DS, params), jck, jcv, jnp.asarray(x_len, jnp.int32),
        jnp.asarray(pos0, jnp.int32), jnp.asarray(plen, jnp.int32),
        seed=jnp.asarray(0, jnp.int32), remaining=jnp.asarray(2 ** 30, jnp.int32),
        temperature=jnp.asarray(1.0, jnp.float32),
        pe_alpha=jnp.asarray(params["ar_audio_position"]["alpha"], jnp.float32),
        steps=steps, s_text=S_TEXT, num_heads=H, vocab=VOCAB, eos=EOS, stochastic=False,
        quant=True, act_quant=mode == "w8a8", kv_scales=kv_scales)
    monkeypatch.undo()

    lw = quantize_weights(pack_layer_weights(model, torch.float32))
    tck, tcv = ck[:, 0], cv[:, 0]
    quant = {}
    if kv:
        tck5, tcv5, scales = TAR.int8_caches(ck, cv)
        tck, tcv, quant = tck5[:, 0], tcv5[:, 0], dict(kv_scales=scales)
    else:
        quant = dict(act_quant=True)
    z = torch.zeros(1)
    r = decode_block_fused(
        torch.tensor([tok0]), z, z.bool(), z, lw, tck, tcv, model.pe, x_len=x_len,
        audio_pos=pos0, remaining=2 ** 30, temperature=1.0, steps=steps, s_text=S_TEXT,
        vocab=VOCAB, eos=EOS, stochastic=False, **quant)
    assert r.fed.tolist() == np.asarray(ytok)[:, 0].tolist()
    assert int(r.next_tok[0]) == int(np.asarray(nxt)[0])
    close(r.step_logits.numpy(), np.asarray(jlogits)[:, 0])
    if kv:
        slots = slice(S_TEXT + pos0, S_TEXT + pos0 + steps)
        want = np.asarray(jck2)[:, slots].reshape(NL, steps, H, HD).transpose(0, 2, 1, 3)
        got = tck[:, :, slots].numpy().astype(np.int32)
        diff = np.abs(got - want.astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


# --- end to end ------------------------------------------------------------------

TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
BUCKETS = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512),
               compute_dtype="float32")


def _bundle(**engine):
    return tapi.preload_models(random_weights=True, device="cpu", seed=3,
                               cfg=ModelConfig(**TINY),
                               ecfg=EngineConfig(**BUCKETS, decode_mode="megakernel",
                                                 **engine))


def _finite(waves, outputs):
    assert [len(w) for w in waves] == [len(c) * 320 for c, _ in outputs]
    assert all(len(w) and np.isfinite(w).all() for w in waves)


@pytest.mark.parametrize("quantize", ["w8a8", "int8kv"])
def test_quantized_routes_run_end_to_end(quantize):
    """One request (greedy, sampled), best_of=3 and a batch of 2 run on the
    kernel path's ops (plain versions on the CPU): finite waveforms of
    frames · 320 samples, the same for the same seed."""
    bundle = _bundle(quantize=quantize)
    w = tapi.generate_audio("Hello.", prompt="paimon", language="en", top_k=1)
    _finite([w], [(bundle.last.codes, None)])
    for kw in (dict(seed=2), dict(best_of=3, seed=2)):
        w1 = tapi.generate_audio("Hello.", prompt="paimon", language="en", **kw)
        res = bundle.last
        _finite([w1], [(res.codes, None)])
        assert res.ar.beam_tokens.shape[0] == kw.get("best_of", 1)
        np.testing.assert_array_equal(
            w1, tapi.generate_audio("Hello.", prompt="paimon", language="en", **kw))
    waves = tapi.generate_audio_batch(["Hello.", "Go now."], ["paimon", None], language="en",
                                      top_k=1)
    assert bundle.last.ar is not None
    _finite(waves, bundle.last.outputs)


def test_int8kv_greedy_tracks_int8_greedy():
    """The int8 KV cache changes the attention by its rounding only: the
    greedy AR tokens of int8kv follow plain int8's for at least 10 frames
    (the JAX package's own standard, tests/test_batch_decode.py:198), for
    one request and for each request of a batch."""
    _bundle(quantize="int8")
    tapi.generate_audio("Hello.", prompt="paimon", language="en", top_k=1)
    ref_one = tapi._bundle.last.codes[:, 0]
    tapi.generate_audio_batch(["Hello.", "Go now."], ["paimon", None], language="en", top_k=1)
    ref_batch = [c[:, 0] for c, _ in tapi._bundle.last.outputs]
    _bundle(quantize="int8kv")
    tapi.generate_audio("Hello.", prompt="paimon", language="en", top_k=1)
    got_one = tapi._bundle.last.codes[:, 0]
    tapi.generate_audio_batch(["Hello.", "Go now."], ["paimon", None], language="en", top_k=1)
    got_batch = [c[:, 0] for c, _ in tapi._bundle.last.outputs]
    for got, ref in [(got_one, ref_one)] + list(zip(got_batch, ref_batch)):
        n = min(len(got), len(ref))
        assert n >= 10
        diff = np.nonzero(got[:n] != ref[:n])[0]
        assert (diff[0] if len(diff) else n) >= 10


def _qmat_jax(x, w_kn, srow):
    """The TPU kernels' `qmat` arithmetic (vallex_tpu/ops/decode_block.py:160-165),
    as jnp ops on [M, K] rows and [K, N] int8 weights → (codes, sx, y)."""
    ax = jnp.max(jnp.abs(x), axis=1, keepdims=True)
    sx = jnp.maximum(ax, 1e-6) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(x / sx), -127.0, 127.0).astype(jnp.int8)
    acc = jax.lax.dot(xq, w_kn, preferred_element_type=jnp.int32)
    return xq, sx, acc.astype(jnp.float32) * (sx * srow)


def test_quantize_rows_and_w8a8_product_match_jax_qmat():
    """`quantize_rows` and the W8A8 plain product (what the prep kernel and
    the int8 tensor-core product compute on the card) against the `qmat`
    arithmetic in JAX: rows whose quotients land on rounding halves (round
    half to even on both sides), an all-zero row (the 1e-6 clamp), a row
    whose extremes quantize to ±127, and random rows. Codes and scales
    equal; the products equal up to f32 rounding of the same operations
    (rtol 1e-6)."""
    from vallex_tpu_torch.kernels.gemm_small_m import gemm_small_m_plain, quantize_rows

    K, N = 128, 48
    rng = np.random.RandomState(3)
    halves = np.zeros(K, np.float32)
    halves[0] = 127.0  # sx = 127 / 127: every other quotient is the value itself
    halves[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    extremes = (rng.standard_normal(K) * 0.1).astype(np.float32)
    extremes[5], extremes[77] = 3.3, -3.3
    x = np.stack([halves, np.zeros(K, np.float32), extremes,
                  *rng.standard_normal((3, K)).astype(np.float32)])
    w = rng.randint(-127, 128, (N, K)).astype(np.int8)
    srow = (rng.rand(N).astype(np.float32) * 0.02 + 1e-3)
    jq, jsx, jy = (np.asarray(a) for a in _qmat_jax(jnp.asarray(x), jnp.asarray(w.T),
                                                   jnp.asarray(srow)))
    tq, tsx = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy().astype(np.int8), jq)
    np.testing.assert_array_equal(tsx.numpy(), jsx)
    assert list(jq[0, 1:9]) == [0, 2, 2, 0, -2, -2, 126, -126]  # halves to even
    assert not jq[1].any() and jsx[1, 0] == np.float32(1e-6) * np.float32(1.0 / 127.0)
    assert jq[2, 5] == 127 and jq[2, 77] == -127
    ty = gemm_small_m_plain(torch.from_numpy(x), torch.from_numpy(w),
                            scale=torch.from_numpy(srow), act_quant=True)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-6, atol=0)
