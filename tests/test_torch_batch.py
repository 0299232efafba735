"""Batched requests in the port (engine/ar.py::ar_generate_batch, the batched
decode_block_fused, masked_attention with per-row bounds, the NAR and Vocos
at batch R, api.generate_audio_batch) against the JAX package, in fp32 on
the CPU at toy width (d 256, 4 heads, 2 + 2 layers).

Greedy tokens are compared exactly: a batched request must emit what the
JAX package's single-request engine emits for it alone, and stop at the
same length cap. Waveforms, NAR codes and Vocos output as stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu.codec import vocos as JVC
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.engine import nar as JNAR
from vallex_tpu.models import layers as JL
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.codec import vocos as TVC
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.engine import ar as TAR
from vallex_tpu_torch.engine import nar as TNAR
from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
from vallex_tpu_torch.kernels import loader, masked_attention_plain
from vallex_tpu_torch.kernels.masked_attention import attention_bounds
from vallex_tpu_torch.ops.decode_block import decode_block_fused
from vallex_tpu_torch.ops.decode_step import pack_layer_weights, quantize_weights

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
JCFG, CFG = JModelConfig(**DIMS), ModelConfig(**DIMS)
BUCKETS = dict(text_buckets=(128,), audio_buckets=(512,), compute_dtype="float32")
EOS = 1024
K = 8


def _requests():
    """Three requests: short prompt, long prompt (its single-request bucket
    cap binds before 16·x_len), no prompt."""
    rng = np.random.RandomState(5)
    reqs = []
    for S, Tp in ((12, 17), (20, 300), (14, 0)):
        text = rng.randint(5, 100, size=S).astype(np.int32)
        prompt = rng.randint(0, 1024, size=Tp).astype(np.int32) if Tp else None
        reqs.append((text, np.zeros(S, np.int32), prompt))
    return reqs


@pytest.fixture(scope="module")
def ref():
    """JAX parameters, the port's model on them, and each request decoded
    alone by the JAX single-request engine (per-token XLA path, greedy)."""
    params = JV.init_vallex(jax.random.PRNGKey(11), JCFG)
    eng = JAR.AREngine(params, JCFG, JEngineConfig(**BUCKETS, decode_mode="xla"))
    reqs = _requests()
    single = [eng.generate(t, lg, p, top_k=1, temperature=1.0)[0] for t, lg, p in reqs]
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)
    return dict(model=model, reqs=reqs, single=single)


def _pad(reqs):
    return TAR.pad_batched_requests(reqs, EOS, 8, BUCKETS["text_buckets"],
                                    BUCKETS["audio_buckets"])


def _batch(model, reqs, packed, *, top_k=1, temperature=1.0, seed=0):
    pb = _pad(reqs)
    return TAR.ar_generate_batch(
        model, CFG, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
        pb["prompt_lens"], pb["caps"], generator=torch.Generator().manual_seed(seed),
        top_k=top_k, temperature=temperature, s_text=pb["s_text"], p_audio=pb["p_audio"],
        t_gen=pb["t_gen"], dtype=torch.float32, decode_steps=K, packed=packed)


def test_padding_and_caps_match_jax():
    """pad_batched_requests / single_request_gen_caps are copies of the JAX
    package's host-side helpers: equal outputs."""
    reqs = _requests()
    t = _pad(reqs)
    j = JAR.pad_batched_requests(reqs, EOS, 8, BUCKETS["text_buckets"],
                                 BUCKETS["audio_buckets"])
    assert set(t) == set(j)
    for k in j:
        if k == "prompts":
            for a, b in zip(t[k], j[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_array_equal(
        TAR.single_request_gen_caps([17, 300, 0], [12, 20, 14], (512, 1024, 2048)),
        JAR.single_request_gen_caps([17, 300, 0], [12, 20, 14], (512, 1024, 2048)))


def test_batch_greedy_equals_jax_single_requests(ref):
    """Each row of the port's greedy batch emits exactly the tokens the JAX
    single-request engine emits for that request alone, and stops at the
    same length (the long-prompt row at its single-request bucket cap)."""
    packed = pack_layer_weights(ref["model"], torch.float32)
    loader.reset_launch_counts()
    res = _batch(ref["model"], ref["reqs"], packed)
    assert sum(loader.launch_counts.values()) == 0  # CPU: plain versions only
    pb = _pad(ref["reqs"])
    caps = np.minimum(16 * pb["x_lens"], pb["caps"])
    assert caps[1] < 16 * pb["x_lens"][1]  # the bucket cap binds for row 1
    for r, single in enumerate(ref["single"]):
        assert res.gen_len[r] == len(single) == caps[r], r
        np.testing.assert_array_equal(res.y_gen[r, : res.gen_len[r]], single,
                                      err_msg=f"request {r}")
        assert (res.y_gen[r, res.gen_len[r]:] == EOS).all()
    assert res.iterations == -(-int(caps.max()) // K)


def test_batch_low_temperature_sampling_emits_greedy_tokens(ref):
    """Sampled path (Gumbel noise from the generator, one [R, VP] draw per
    step) at temperature 1e-6, the epilogue's floor: the noise spans ~20
    (u in [0, 1)), so at 1e-6 it moves scores by ~2e-5, below this model's
    top-2 logit gaps, and every row must emit its greedy tokens — a check
    of the sampled path's row routing that needs no PRNG match. (At 1e-3
    the noise, ~2e-2, exceeds one of the ~700 steps' top-2 gap: logits of
    this toy model have a spread of ~0.6 over 1025 tokens.)"""
    packed = pack_layer_weights(ref["model"], torch.float32)
    sampled = _batch(ref["model"], ref["reqs"], packed, top_k=-100,
                     temperature=1e-6, seed=7)
    for r, single in enumerate(ref["single"]):
        np.testing.assert_array_equal(sampled.y_gen[r, : sampled.gen_len[r]], single)


def test_batched_block_rows_equal_single_row_blocks(ref):
    """One batched decode_block_fused over three rows equals the same block
    run on each row alone (B = 1, same cache contents): fed tokens and step
    logits exactly (fp32, plain versions), caches written identically."""
    model = ref["model"]
    packed = pack_layer_weights(model, torch.float32)
    pb = _pad(ref["reqs"])
    R, s_text, p_audio, t_gen = len(ref["reqs"]), pb["s_text"], pb["p_audio"], pb["t_gen"]
    y_init = torch.cat([torch.full((R, 1), 1025), torch.from_numpy(pb["prompt_pad"]).long()], 1)
    xl = torch.from_numpy(pb["x_lens"])
    pl = torch.from_numpy(pb["prompt_lens"])
    ck, cv, logits0 = TAR.prefill(
        model, CFG, torch.from_numpy(pb["text"]), torch.from_numpy(pb["lang"]), xl, y_init,
        pl, s_text=s_text, p_audio=p_audio, C=s_text + p_audio + t_gen + K,
        dtype=torch.float32)
    tok0 = logits0.argmax(-1).to(torch.int32)
    kw = dict(audio_pos=5, temperature=1.0, steps=K, s_text=s_text, vocab=1025, eos=EOS,
              stochastic=False, batched=True, p_audio=p_audio)
    z = torch.zeros(R)
    remaining = torch.tensor([100, 3, 100])  # row 1 hits its cap inside the block
    both = decode_block_fused(tok0, z, torch.zeros(R, dtype=torch.bool), z, packed,
                              ck.clone(), cv.clone(), model.pe, x_len=xl,
                              remaining=remaining, prompt_len=pl, **kw)
    for r in range(R):
        one = decode_block_fused(tok0[r:r + 1], z[:1], torch.zeros(1, dtype=torch.bool), z[:1],
                                 packed, ck[:, r:r + 1].clone(), cv[:, r:r + 1].clone(),
                                 model.pe, x_len=xl[r:r + 1], remaining=remaining[r:r + 1],
                                 prompt_len=pl[r:r + 1], **kw)
        assert both.fed[:, r].tolist() == one.fed[:, 0].tolist()
        np.testing.assert_allclose(both.step_logits[:, r].numpy(),
                                   one.step_logits[:, 0].numpy(), atol=1e-5, rtol=1e-5)
    assert both.fed[3:, 1].tolist() == [EOS] * (K - 3) and bool(both.done[1])


def test_int8_serving_tokens_equal_plain_int8_reference(ref):
    """quantize="int8" (W8A16, no speculation): the single request's K-step
    blocks and each row of the batch emit the tokens of the port's plain
    int8 reference — the same request decoded one step per block."""
    model = ref["model"]
    int8 = quantize_weights(pack_layer_weights(model, torch.float32))
    pipe = SynthesisPipeline(model, CFG, EngineConfig(**BUCKETS, quantize="int8",
                                                      decode_mode="megakernel"))
    batched = _batch(model, ref["reqs"], int8)
    for r, (text, lang, prompt) in enumerate(ref["reqs"]):
        S, Tp = len(text), 0 if prompt is None else len(prompt)
        prompt_pad = np.full(511, EOS, np.int64)
        if Tp:
            prompt_pad[:Tp] = prompt
        text_pad = np.zeros(128, np.int64)
        text_pad[:S] = text
        refr = TAR.ar_generate(
            model, CFG, text_pad, np.zeros(128, np.int64), S, prompt_pad, Tp,
            generator=torch.Generator(), top_k=1, temperature=1.0, gen_limit=None,
            s_text=128, p_audio=512, t_audio=512, dtype=torch.float32,
            decode_mode="megakernel", decode_steps=1, speculative=False, packed=int8)
        want = refr.tokens[Tp + 1: Tp + 1 + refr.gen_len]
        single = pipe.synthesize(text, lang, None if prompt is None else
                                 np.repeat(prompt[:, None], 8, 1), top_k=1, return_wave=False)
        assert single.ar.iterations < refr.iterations  # K frames per block
        np.testing.assert_array_equal(single.codes[:, 0], want, err_msg=f"single {r}")
        np.testing.assert_array_equal(batched.y_gen[r, : batched.gen_len[r]], want,
                                      err_msg=f"batched {r}")


@pytest.mark.parametrize("Tq,q_off", [(1, 1), (4, 1), (6, 0)])
def test_masked_attention_per_row_bounds(Tq, q_off):
    """Per-row bounds with both audio ranges equal a loop of B = 1 calls,
    and each row equals jnp attention_core under the contract's additive
    mask built key by key (atol = rtol = 1e-5, f32)."""
    rng = np.random.RandomState(Tq)
    B, C, s_text, gen_lo = 3, 96, 16, 48
    q = rng.randn(B, H, Tq, 16).astype(np.float32)
    k = rng.randn(B, H, C, 16).astype(np.float32)
    v = rng.randn(B, H, C, 16).astype(np.float32)
    xl, a1, a2 = np.array([3, 16, 9]), np.array([1, 20, 32]), np.array([5, 0, 30])
    tq = lambda a: torch.from_numpy(a)  # noqa: E731
    b = attention_bounds(B, x_len=tq(xl), s_text=s_text, audio_len=tq(a1), q_off=q_off,
                         gen_lo=gen_lo, gen_len=tq(a2))
    got = masked_attention_plain(tq(q), tq(k), tq(v), b).numpy()
    for r in range(B):
        one = masked_attention_plain(
            tq(q[r:r + 1]), tq(k[r:r + 1]), tq(v[r:r + 1]), x_len=int(xl[r]), s_text=s_text,
            audio_len=int(a1[r]), q_off=q_off, gen_lo=gen_lo, gen_len=int(a2[r])).numpy()
        np.testing.assert_allclose(got[r:r + 1], one, atol=1e-5, rtol=1e-5)
        mask = np.full((Tq, C), -1e9, np.float32)
        for qi in range(Tq):
            for c in range(C):
                if (c < xl[r] or s_text <= c < s_text + a1[r]
                        or gen_lo <= c < gen_lo + a2[r] + q_off * qi):
                    mask[qi, c] = 0.0
        j = JL.attention_core(q[r:r + 1], k[r:r + 1], v[r:r + 1], mask[None, None])
        np.testing.assert_allclose(got[r:r + 1], np.asarray(j), atol=1e-5, rtol=1e-5)
    # the single-request layout is range 2 from s_text with range 1 empty
    single = attention_bounds(1, x_len=7, s_text=s_text, audio_len=11, q_off=q_off)
    assert single.lens[:, 0].tolist() == [7, 0, 11] and single.a2_lo == s_text


@pytest.mark.parametrize("t_audio", [64, 1536])
def test_nar_batch_codes_equal_jax(ref, t_audio):
    """The NAR at batch R with per-row x_len / t_len / prompt_len ([R]
    tensors) emits the JAX package's batched nar_generate codes exactly
    (t_audio 1536 routes attention through flash_attention_fwd's wrapper,
    segments (ok, ok) and prefix C)."""
    params = JV.init_vallex(jax.random.PRNGKey(11), JCFG)
    model = ref["model"]
    rng = np.random.RandomState(t_audio)
    s_text = 16
    xl, pl, tl = np.array([12, 5, 16]), np.array([9, 0, 20]), np.array([29, 17, 48])
    text = rng.randint(5, 500, (3, s_text))
    lang = np.zeros((3, s_text), np.int64)
    codes = np.zeros((3, t_audio, 8), np.int64)
    for r in range(3):
        codes[r, : pl[r]] = rng.randint(0, 1024, (pl[r], 8))
        codes[r, pl[r]: tl[r], 0] = rng.randint(0, 1024, tl[r] - pl[r])
    j = JNAR.nar_generate(params, JCFG, jnp.asarray(text, jnp.int32), jnp.asarray(lang, jnp.int32),
                          jnp.asarray(xl), jnp.asarray(codes, jnp.int32), jnp.asarray(tl),
                          jnp.asarray(pl), s_text=s_text, t_audio=t_audio,
                          compute_dtype="float32")
    t = TNAR.nar_generate(model, CFG, torch.from_numpy(text), torch.from_numpy(lang),
                          torch.from_numpy(xl), torch.from_numpy(codes), torch.from_numpy(tl),
                          torch.from_numpy(pl), dtype=torch.float32)
    for r in range(3):
        np.testing.assert_array_equal(t[r, : tl[r]].numpy(), np.asarray(j)[r, : tl[r]])


def test_vocos_batch_per_row_lengths_close_to_jax():
    """Vocos on a batch with per-row t_len: each row's valid samples match
    the JAX vocoder at atol = rtol = 1e-4, and equal a run of that row
    alone — zero codes past a row's length do not leak into it."""
    params = JVC.init_vocos(jax.random.PRNGKey(1))
    vocos = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(3)
    T, tl = 40, np.array([33, 12, 40])
    codes = np.zeros((3, T, 8), np.int64)
    for r in range(3):
        codes[r, : tl[r]] = rng.randint(0, 1024, (tl[r], 8))
    j = np.asarray(JVC.vocos_decode(params, jnp.asarray(codes, jnp.int32), 2,
                                    t_len=jnp.asarray(tl)))
    t = TVC.vocos_decode(vocos, torch.from_numpy(codes), 2, t_len=torch.from_numpy(tl)).numpy()
    for r in range(3):
        n = tl[r] * TVC.HOP
        np.testing.assert_allclose(t[r, :n], j[r, :n], atol=1e-4, rtol=1e-4)
        alone = TVC.vocos_decode(vocos, torch.from_numpy(codes[r:r + 1]), 2,
                                 t_len=int(tl[r])).numpy()
        np.testing.assert_allclose(t[r, :n], alone[0, :n], atol=1e-5, rtol=1e-5)


TEXTS = ["Hi there.", "Go now.", "Good morning."]
PROMPTS = ["paimon", None, "emo_amused"]


@pytest.fixture(scope="module")
def jax_waves(tmp_path_factory):
    jb = japi.preload_models(str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
                             cfg=JCFG, ecfg=JEngineConfig(**BUCKETS), seed=4)
    waves = [japi.generate_audio(t, p, language="en", top_k=1) for t, p in zip(TEXTS, PROMPTS)]
    return dict(params=jax.tree.map(np.asarray, jb.params),
                vocos=jax.tree.map(np.asarray, jb.vocos_params), waves=waves)


def test_generate_audio_batch_matches_jax_per_request(jax_waves):
    """api.generate_audio_batch (batched AR, NAR and Vocos) against the JAX
    package's generate_audio of each request alone: waveforms at
    atol = rtol = 1e-4 (f32 on both sides; irfft against a DFT matmul)."""
    tapi.preload_models(params=jax_waves["params"], vocos_params=jax_waves["vocos"],
                        device="cpu", cfg=CFG, ecfg=EngineConfig(**BUCKETS))
    waves = tapi.generate_audio_batch(TEXTS, PROMPTS, language="en", top_k=1)
    res = tapi._bundle.last
    assert res.ar is not None and set(res.seconds) == {"ar", "nar", "vocos", *TAR.SECONDS}
    for r, (w, want) in enumerate(zip(waves, jax_waves["waves"])):
        assert w.shape == want.shape == (len(res.outputs[r][0]) * 320,), r
        np.testing.assert_allclose(w, want, atol=1e-4, rtol=1e-4, err_msg=f"request {r}")


@pytest.mark.parametrize("kwargs", [dict(best_of=2), dict(top_k=5), dict(top_p=0.9)],
                         ids=["best_of", "top_k", "top_p"])
def test_batch_configs_outside_the_slice_raise(jax_waves, kwargs):
    """best_of, top_k and top_p now run on the batched path: one finite
    waveform of frames · 320 samples per request, the same for the same
    seed, and with best_of one score per sample of each request."""
    bundle = tapi.preload_models(params=jax_waves["params"], vocos_params=jax_waves["vocos"],
                                 device="cpu", cfg=CFG, ecfg=EngineConfig(**BUCKETS))
    waves = tapi.generate_audio_batch(TEXTS[:2], language="en", seed=1, **kwargs)
    res = bundle.last
    assert res.ar.scores.shape == (2, kwargs.get("best_of", 1))
    assert [len(w) for w in waves] == [len(c) * 320 for c, _ in res.outputs]
    assert all(len(w) and np.isfinite(w).all() for w in waves)
    again = tapi.generate_audio_batch(TEXTS[:2], language="en", seed=1, **kwargs)
    for a, b in zip(waves, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize", ["int8kv", "w8a8"])
def test_batch_quantize_modes_outside_the_slice_raise(jax_waves, quantize):
    """int8kv and w8a8 now run: generate_audio_batch (the batched K-step
    blocks: int8 caches with batch-wide scales, or W8A8 products) and
    generate_audio on the kernel path, each a finite waveform of frames ·
    320 samples per request."""
    bundle = tapi.preload_models(params=jax_waves["params"], vocos_params=jax_waves["vocos"],
                                 device="cpu", cfg=CFG,
                                 ecfg=EngineConfig(**BUCKETS, quantize=quantize,
                                                   decode_mode="megakernel"))
    waves = tapi.generate_audio_batch(TEXTS[:2], language="en", top_k=1)
    res = bundle.last
    assert res.ar is not None
    assert [len(w) for w in waves] == [len(c) * 320 for c, _ in res.outputs]
    assert all(len(w) and np.isfinite(w).all() for w in waves)
    wave = tapi.generate_audio(TEXTS[0], language="en", top_k=1)
    assert len(wave) == len(bundle.last.codes) * 320 > 0 and np.isfinite(wave).all()


def test_beams_raise_in_ar_generate_batch(ref):
    """beams=2 now runs in ar_generate_batch (the grouped layout): greedy
    samples are copies, so each request keeps the first and emits the JAX
    single-request engine's tokens, with two equal scores."""
    packed = pack_layer_weights(ref["model"], torch.float32)
    pb = _pad(ref["reqs"])
    res = TAR.ar_generate_batch(
        ref["model"], CFG, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"],
        pb["prompt_lens"], pb["caps"], generator=torch.Generator(), top_k=1,
        temperature=1.0, s_text=pb["s_text"], p_audio=pb["p_audio"], t_gen=pb["t_gen"],
        dtype=torch.float32, decode_steps=K, packed=packed, beams=2)
    assert res.scores.shape == (3, 2)
    np.testing.assert_array_equal(res.scores[:, 0], res.scores[:, 1])
    for r, single in enumerate(ref["single"]):
        assert res.gen_len[r] == len(single)
        np.testing.assert_array_equal(res.y_gen[r, : res.gen_len[r]], single)


def test_kernel_c_signatures_match_ctypes():
    """Each extern "C" launcher's parameter list (pointer / int / float per
    argument) matches the argtypes the loader gives ctypes: a mismatch
    would only show as a failed launch on the card."""
    import ctypes
    import re

    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    for name in loader.SOURCES:
        src = (loader.SRC_DIR / name).read_text()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            want = ["ptr" if "*" in p else p.split()[-2] for p in
                    (" ".join(q.split()) for q in params.split(","))]
            assert [kinds[t] for t in loader._SIGNATURES[fn]] == want, fn
