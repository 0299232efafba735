"""best_of samples and long text in the port against the JAX package, in
fp32 on the CPU at toy width (d 256, 4 heads, 2 + 2 layers; long text at
d 64).

- Greedy ar_generate(beams=3): the port's sample buffers, best sample and
  gen_len equal JAX's ar_generate(decode_mode="xla", beams=3), through the
  port's per-token path and its kernel path (the grouped rows; plain
  versions on the CPU).
- Best-sample selection equals vallex_tpu/engine/ar.py:824-832 on JAX's own
  sampled beams, with length_penalty 1.0 and 0.6.
- Grouped ar_generate_batch(beams=B) is bitwise the same requests expanded
  B times at beams=1, fed the same uniforms (the property of
  tests/test_batch_decode.py::test_beam_batched_best_of_exactness).
- generate_audio_from_long_text in both modes gives the JAX package's
  greedy codes exactly; the stream gives the same codes per sentence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.engine import ar as JAR
from vallex_tpu.models import vallex as JV
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.engine import ar as TAR
from vallex_tpu_torch.kernels import loader
from vallex_tpu_torch.ops.decode_step import pack_layer_weights

torch.set_num_threads(1)

D, H, NL = 256, 4, 2
DIMS = dict(d_model=D, num_heads=H, num_layers=NL, ffn_dim=2 * D)
JCFG, CFG = JModelConfig(**DIMS), ModelConfig(**DIMS)
EOS, K = 1024, 8
S_TEXT, P_AUDIO, T_AUDIO = 128, 512, 512


@pytest.fixture(scope="module")
def ref():
    params = JV.init_vallex(jax.random.PRNGKey(11), JCFG)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg=CFG)
    rng = np.random.RandomState(5)
    S, Tp = 12, 17
    text = np.zeros(S_TEXT, np.int32)
    text[:S] = rng.randint(5, 100, size=S)
    prompt = np.full(P_AUDIO - 1, EOS, np.int32)
    prompt[:Tp] = rng.randint(0, 1024, size=Tp)
    return dict(params=params, model=model, text=text, S=S, prompt=prompt, Tp=Tp)


def _jax_beams(ref, beams, *, top_k, length_penalty=1.0, seed=0):
    r = JAR.ar_generate(
        ref["params"], JCFG, jnp.asarray(ref["text"])[None],
        jnp.zeros((1, S_TEXT), jnp.int32), jnp.asarray(ref["S"], jnp.int32),
        jnp.asarray(ref["prompt"])[None], jnp.asarray(ref["Tp"], jnp.int32),
        jax.random.PRNGKey(seed), jnp.asarray(top_k, jnp.int32), jnp.asarray(1.0, jnp.float32),
        jnp.asarray(1.0, jnp.float32), s_text=S_TEXT, p_audio=P_AUDIO, t_audio=T_AUDIO,
        beams=beams, compute_dtype="float32", length_penalty=length_penalty,
        decode_mode="xla", plain_sampling=True, greedy=top_k == 1)
    return [np.asarray(a) for a in (r.tokens, r.gen_len, r.best_beam, r.avg_logprobs)]


def _port_beams(ref, beams, mode, **kw):
    packed = pack_layer_weights(ref["model"], torch.float32) if mode == "megakernel" else None
    return TAR.ar_generate(
        ref["model"], CFG, ref["text"], np.zeros(S_TEXT, np.int32), ref["S"], ref["prompt"],
        ref["Tp"], generator=torch.Generator().manual_seed(0), temperature=1.0,
        gen_limit=None, s_text=S_TEXT, p_audio=P_AUDIO, t_audio=T_AUDIO, dtype=torch.float32,
        decode_mode=mode, decode_steps=K, speculative=False, packed=packed, beams=beams, **kw)


@pytest.mark.parametrize("mode", ["xla", "megakernel"], ids=["per-token", "kernels"])
def test_greedy_beams_equal_jax(ref, mode):
    """Three greedy samples are three copies of the greedy decode: every
    buffer, the pick (the first of the tied scores) and gen_len equal JAX's;
    the kernel path runs them as grouped rows over one shared prefix."""
    y, gen_len, best, _ = _jax_beams(ref, 3, top_k=1)
    loader.reset_launch_counts()
    r = _port_beams(ref, 3, mode, top_k=1)
    assert sum(loader.launch_counts.values()) == 0  # CPU: plain versions only
    assert r.beam_tokens.shape[0] == 3 and r.best_beam == int(best) == 0
    np.testing.assert_array_equal(r.beam_tokens[:, :T_AUDIO], y)
    assert (r.beam_tokens[:, T_AUDIO:] == EOS).all()
    np.testing.assert_array_equal(r.tokens[:T_AUDIO], y[int(best)])
    assert r.gen_len == int(gen_len) > 0
    if mode == "megakernel":
        assert r.iterations == -(-r.gen_len // K)


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_best_sample_selection_equals_jax(ref, length_penalty):
    """JAX's own sampled beams (per-token path, 4 samples): from their
    buffers and scores, the port's select_best recovers JAX's pick and
    scores (lengths count every non-EOS entry, BOS and prompt included)."""
    y, gen_len, best, avg = _jax_beams(ref, 4, top_k=-100, length_penalty=length_penalty,
                                       seed=3)
    lengths = (y != EOS).sum(1)
    assert len(set(lengths.tolist())) > 1 or len(set(avg.tolist())) > 1
    sums = avg.astype(np.float64) * lengths.astype(np.float64) ** length_penalty
    tb, ts = TAR.select_best(torch.from_numpy(sums.astype(np.float32)),
                             torch.from_numpy(lengths), length_penalty)
    assert int(tb) == int(best)
    np.testing.assert_allclose(ts.numpy(), avg, rtol=1e-6)
    assert int((y[int(best)] != EOS).sum()) - (1 + ref["Tp"]) == int(gen_len)


def test_select_best_ties_and_penalty():
    """Given sums and lengths: the first of equal scores wins; a length
    penalty below 1 normalizes less, so a longer sample's larger loss can
    lose where it won at 1.0."""
    sums = torch.tensor([[-10.0, -10.0, -12.0], [-20.0, -36.0, -50.0]])
    lengths = torch.tensor([[10, 10, 12], [10, 20, 20]])
    best, scores = TAR.select_best(sums, lengths, 1.0)
    assert best.tolist() == [0, 1]  # three scores of -1.0; -1.8 beats -2.0 and -2.5
    np.testing.assert_allclose(scores.numpy(), [[-1.0, -1.0, -1.0], [-2.0, -1.8, -2.5]])
    best, scores = TAR.select_best(sums, lengths, 0.6)
    assert best.tolist() == [0, 0]  # -20 / 10**0.6 = -5.02 beats -36 / 20**0.6 = -5.97
    np.testing.assert_allclose(scores.numpy(), (sums / lengths.double() ** 0.6).numpy(),
                               rtol=1e-6)


def _batch_reqs():
    rng = np.random.RandomState(5)
    return [(rng.randint(5, 100, size=S).astype(np.int32), np.zeros(S, np.int32),
             rng.randint(0, 1024, size=Tp).astype(np.int32) if Tp else None)
            for S, Tp in ((12, 17), (14, 0))]


def _batch(model, reqs, beams, **kw):
    pb = TAR.pad_batched_requests(reqs, EOS, 8, (128,), (512,))
    return TAR.ar_generate_batch(
        model, CFG, pb["text"], pb["lang"], pb["x_lens"], pb["prompt_pad"], pb["prompt_lens"],
        pb["caps"], generator=torch.Generator().manual_seed(7), temperature=1.0,
        s_text=pb["s_text"], p_audio=pb["p_audio"], t_gen=pb["t_gen"], dtype=torch.float32,
        decode_steps=K, packed=pack_layer_weights(model, torch.float32), beams=beams, **kw)


@pytest.mark.parametrize("sampling", [dict(top_k=-100), dict(top_k=5, top_p=0.9), dict(top_k=1)],
                         ids=["sampled", "filtered", "greedy"])
def test_grouped_batch_beams_equal_expanded_rows(ref, sampling):
    """2 requests × 3 samples in the grouped layout against the 6 expanded
    rows at beams=1, both fed the same uniforms ([6, VP] per step): every
    sample's score equal bitwise, and each request's pick is its argmax row,
    with that row's tokens and length."""
    B = 3
    reqs = _batch_reqs()
    g = _batch(ref["model"], reqs, B, **sampling)
    e = _batch(ref["model"], [r for r in reqs for _ in range(B)], 1, **sampling)
    assert g.scores.shape == (2, B) and e.scores.shape == (2 * B, 1)
    np.testing.assert_array_equal(g.scores.reshape(-1), e.scores.reshape(-1))
    for r in range(2):
        row = r * B + int(np.argmax(g.scores[r]))
        np.testing.assert_array_equal(g.y_gen[r], e.y_gen[row])
        assert g.gen_len[r] == e.gen_len[row]
    if sampling["top_k"] != 1:  # the samples differ
        assert len(set(g.scores.reshape(-1).tolist())) > 2


LT_DIMS = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
LT_ENGINE = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512),
                 compute_dtype="float32", top_k=1)
LONG = "Hello there. Good morning to you. See you soon."


@pytest.fixture(scope="module")
def jax_long(tmp_path_factory):
    jb = japi.preload_models(str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
                             cfg=JModelConfig(**LT_DIMS), ecfg=JEngineConfig(**LT_ENGINE),
                             seed=4)
    out = {}
    orig = japi.codes_to_wave
    try:
        for mode in ("fixed-prompt", "sliding-window"):
            japi.codes_to_wave = lambda b, c, mode=mode: out.__setitem__(mode, c) or orig(b, c)
            japi.generate_audio_from_long_text(LONG, "paimon", language="en", mode=mode, seed=1)
    finally:
        japi.codes_to_wave = orig
    return dict(params=jax.tree.map(np.asarray, jb.params),
                vocos=jax.tree.map(np.asarray, jb.vocos_params), codes=out)


@pytest.mark.parametrize("decode_mode", ["auto", "megakernel"], ids=["per-token", "kernels"])
@pytest.mark.parametrize("mode", ["fixed-prompt", "sliding-window"])
def test_long_text_codes_equal_jax(jax_long, monkeypatch, mode, decode_mode):
    """Greedy long text: the port's concatenated codes equal the JAX
    package's in both modes (on the kernel path the fixed-prompt sentences
    run as one batch); the waveform is frames · 320 samples."""
    tapi.preload_models(params=jax_long["params"], vocos_params=jax_long["vocos"],
                        device="cpu", cfg=ModelConfig(**LT_DIMS),
                        ecfg=EngineConfig(**LT_ENGINE, decode_mode=decode_mode))
    got = {}
    orig = tapi.codes_to_wave
    monkeypatch.setattr(tapi, "codes_to_wave",
                        lambda b, c: got.setdefault("codes", c) is c and orig(b, c))
    wave = tapi.generate_audio_from_long_text(LONG, "paimon", language="en", mode=mode, seed=1)
    want = jax_long["codes"][mode]
    np.testing.assert_array_equal(got["codes"], want)
    assert wave.shape == (len(want) * 320,) and np.isfinite(wave).all()
    batched = getattr(tapi._bundle.last, "outputs", None) is not None
    assert batched == (decode_mode == "megakernel" and mode == "fixed-prompt")


@pytest.mark.parametrize("mode", ["fixed-prompt", "sliding-window"])
def test_long_text_stream_yields_each_sentence(jax_long, mode):
    """stream_audio_from_long_text yields one waveform per sentence, whose
    lengths add up to the JAX package's codes (kernel path: the first
    sentence alone, then a batch)."""
    tapi.preload_models(params=jax_long["params"], vocos_params=jax_long["vocos"],
                        device="cpu", cfg=ModelConfig(**LT_DIMS),
                        ecfg=EngineConfig(**LT_ENGINE, decode_mode="megakernel"))
    waves = list(tapi.stream_audio_from_long_text(LONG, "paimon", language="en", mode=mode,
                                                  seed=1))
    assert len(waves) == 3 and all(np.isfinite(w).all() and len(w) for w in waves)
    assert sum(len(w) for w in waves) == len(jax_long["codes"][mode]) * 320
