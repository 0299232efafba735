"""The port's Whisper (vallex_tpu_torch/asr/whisper.py) and its transcription
entry (utils/whisper_transcribe.py) against the JAX package on the CPU, in
fp32, at a narrow width (d 64, 4 heads, 2 + 2 layers) with the real
vocabulary and special ids.

Tolerances: the log-mel within 1e-4; encoder states and logits within 1e-4
of their scale; greedy ids, the detected language and the ranked lane
equal; converted trees bitwise. Sampled lanes are held in distribution
only (torch.Generator is not JAX's PRNG): at a low temperature they equal
greedy, and each lane's score equals its teacher-forced logprob sum.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.asr import whisper as JW
from vallex_tpu.utils import whisper_transcribe as JWT
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.asr import whisper as TW
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.utils import audio as TAU
from vallex_tpu_torch.utils import whisper_transcribe as TWT

torch.set_num_threads(2)

NARROW = dict(d_model=64, num_heads=4, encoder_layers=2, decoder_layers=2)
JCFG, CFG = JW.WhisperConfig(**NARROW), TW.WhisperConfig(**NARROW)


def _scale_close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


@pytest.fixture(scope="module")
def both():
    """JAX params, the port's model with the same values, a 3 s clip's mel
    and the JAX encoder states."""
    params = JW.init_whisper(jax.random.PRNGKey(5), JCFG)
    model = params_from_jax(jax.tree.map(np.array, params), cfg=CFG)
    wav = (np.random.RandomState(3).randn(48000) * 0.1).astype(np.float32)
    mel = np.array(JW.log_mel_spectrogram(jnp.asarray(JW.pad_or_trim(wav))))
    enc = np.array(JW.encode(params, JCFG, jnp.asarray(mel)))
    return params, model, wav, mel, enc


def _prefix(cfg, lang_id):
    return [cfg.sot, lang_id, cfg.transcribe, cfg.no_timestamps]


def test_log_mel_spectrogram_matches_jax(both):
    _, _, wav, mel, _ = both
    got = TW.log_mel_spectrogram(torch.from_numpy(TW.pad_or_trim(wav))).numpy()
    assert got.shape == mel.shape == (80, 3000)
    np.testing.assert_allclose(got, mel, atol=1e-4, rtol=0)


def test_encoder_and_decoder_logits_match_jax(both):
    params, model, _, mel, enc = both
    got = TW.encode(model, torch.from_numpy(mel)).numpy()
    assert got.shape == enc.shape == (1500, 64)
    _scale_close(got, enc)
    toks = np.asarray(_prefix(JCFG, JCFG.lang_base) + [100, 2000, 30000], np.int32)
    want = np.asarray(JW.decoder_forward(params, JCFG, jnp.asarray(toks), jnp.asarray(enc)))
    logits = TW.decoder_forward(model, torch.from_numpy(toks).long(), torch.from_numpy(enc))
    assert logits.shape == want.shape == (7, 51865)
    _scale_close(logits.numpy(), want)


def test_greedy_decode_and_detect_language_match_jax(both):
    """The KV-cached greedy loop gives the JAX package's ids; the detected
    language token is the same."""
    params, model, _, _, enc = both
    lang = JW.detect_language(params, JCFG, jnp.asarray(enc))
    assert TW.detect_language(model, torch.from_numpy(enc)) == lang
    prefix = np.asarray(_prefix(JCFG, lang), np.int32)
    want = np.asarray(JW.greedy_decode(params, JCFG, jnp.asarray(enc), jnp.asarray(prefix),
                                       prefix_len=4, max_len=24))
    got = TW.greedy_decode(model, torch.from_numpy(enc), torch.from_numpy(prefix).long(),
                           max_len=24).numpy()
    np.testing.assert_array_equal(got, want)


def test_transcribe_ids_greedy_matches_jax(both):
    params, model, wav, _, _ = both
    want_ids, want_lang = JW.transcribe_ids(params, JCFG, wav, max_len=16)
    ids, lang = TW.transcribe_ids(model, wav, max_len=16)
    assert lang == want_lang
    np.testing.assert_array_equal(ids, want_ids)


def test_sampled_decode_low_temperature_equals_greedy(both):
    _, model, _, _, enc = both
    e = torch.from_numpy(enc)
    prefix = torch.tensor(_prefix(CFG, TW.detect_language(model, e)))
    g = TW.greedy_decode(model, e, prefix, max_len=16)
    buf, _ = TW.sampled_decode(model, e, prefix, torch.Generator().manual_seed(0), max_len=16,
                               best_of=3, temperature=1e-4)
    for b in range(3):
        np.testing.assert_array_equal(buf[b].numpy(), g.numpy())


def test_sampled_decode_scores_teacher_forced(both):
    """Each lane's sum_logprobs is the UNSCALED log-softmax of its own
    tokens under the teacher-forced decoder of the JAX package, summed up
    to and including the first eot (within 1e-4 of its magnitude); every
    lane keeps its own cache."""
    params, model, _, _, enc = both
    prefix = _prefix(CFG, CFG.lang_base)
    buf, sum_lp = TW.sampled_decode(model, torch.from_numpy(enc), torch.tensor(prefix),
                                    torch.Generator().manual_seed(11), max_len=14, best_of=3,
                                    temperature=1.0)
    buf, sum_lp = buf.numpy(), sum_lp.numpy()
    assert len({tuple(r) for r in buf}) > 1  # lanes drew their own tokens
    for b in range(3):
        emitted = buf[b, 4:]
        nz = np.nonzero(emitted == CFG.eot)[0]
        n = int(nz[0]) + 1 if len(nz) else len(emitted)
        seq = buf[b, : 4 + n]
        logits = np.asarray(JW.decoder_forward(params, JCFG, jnp.asarray(seq, jnp.int32),
                                               jnp.asarray(enc)), np.float64)
        lp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1,
                             keepdims=True)) - logits.max(-1, keepdims=True)
        ref = sum(lp[3 + j, seq[4 + j]] for j in range(n))
        np.testing.assert_allclose(sum_lp[b], ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("case", ["avg-beats-sum", "no-eot", "tie"])
def test_rank_samples_matches_jax(case):
    eot = 500
    buf, lp = {
        "avg-beats-sum": ([[1, 2, 3, 4, 10, 11, 12, 13, eot, eot],
                           [1, 2, 3, 4, 20, 21, eot, eot, eot, eot],
                           [1, 2, 3, 4, 30, 31, 32, 33, 34, 35]], [-4.0, -1.0, -9.0]),
        "no-eot": ([[1, 2, 3, 4, 5, 6], [1, 2, 3, 4, eot, eot]], [-6.0, -0.5]),
        "tie": ([[1, 2, 3, 4, 5, eot], [1, 2, 3, 4, 6, eot]], [-1.0, -1.0]),
    }[case]
    buf, lp = np.asarray(buf), np.asarray(lp)
    assert (TW.rank_samples(buf, lp, prefix_len=4, eot=eot)
            == JW.rank_samples(buf, lp, prefix_len=4, eot=eot))


def _hf_state_dict(cfg, seed=0):
    """A HuggingFace WhisperForConditionalGeneration state dict (module
    paths, [out, in] linears, [D, in, 3] convs) of random values."""
    rng = np.random.RandomState(seed)
    d, sd = cfg.d_model, {}

    def put(name, *shape):
        sd[name] = rng.randn(*shape).astype(np.float32)

    def attn(p):
        for k in ("q", "k", "v"):
            put(f"{p}.{k}_proj.weight", d, d)
        put(f"{p}.q_proj.bias", d)
        put(f"{p}.v_proj.bias", d)
        put(f"{p}.out_proj.weight", d, d)
        put(f"{p}.out_proj.bias", d)

    def block(p, cross):
        attn(f"{p}.self_attn")
        for ln in ["self_attn_layer_norm", "final_layer_norm"] + (
                ["encoder_attn_layer_norm"] if cross else []):
            put(f"{p}.{ln}.weight", d)
            put(f"{p}.{ln}.bias", d)
        put(f"{p}.fc1.weight", 4 * d, d)
        put(f"{p}.fc1.bias", 4 * d)
        put(f"{p}.fc2.weight", d, 4 * d)
        put(f"{p}.fc2.bias", d)
        if cross:
            attn(f"{p}.encoder_attn")

    put("model.encoder.conv1.weight", d, 80, 3)
    put("model.encoder.conv1.bias", d)
    put("model.encoder.conv2.weight", d, d, 3)
    put("model.encoder.conv2.bias", d)
    put("model.encoder.embed_positions.weight", cfg.max_source_positions, d)
    for i in range(cfg.encoder_layers):
        block(f"model.encoder.layers.{i}", False)
    for side in ("encoder", "decoder"):
        put(f"model.{side}.layer_norm.weight", d)
        put(f"model.{side}.layer_norm.bias", d)
    put("model.decoder.embed_tokens.weight", cfg.vocab, d)
    put("model.decoder.embed_positions.weight", cfg.max_target_positions, d)
    for i in range(cfg.decoder_layers):
        block(f"model.decoder.layers.{i}", True)
    return sd


def test_convert_hf_state_dict_matches_jax():
    """Every leaf bitwise the JAX package's conversion; the tree loads into
    the port's module."""
    sd = _hf_state_dict(CFG)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, JW.convert_hf_state_dict(sd, JCFG)))
    tree = TW.convert_hf_state_dict(sd, CFG)
    got = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    model = params_from_jax(tree, cfg=CFG)
    np.testing.assert_array_equal(model.dec_blocks[1].cross_attn.k_w.numpy(),
                                  sd["model.decoder.layers.1.encoder_attn.k_proj.weight"].T)


def test_transcribe_without_weights_asks_for_a_transcript(tmp_path, monkeypatch):
    """No WHISPER_MODEL_DIR and no ./checkpoints/whisper-medium: the JAX
    package's message, from transcribe and from a transcript-less
    make_prompt."""
    monkeypatch.delenv("WHISPER_MODEL_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError) as jerr:
        JWT._find_model_dir()
    with pytest.raises(RuntimeError) as err:
        TWT.transcribe("clip.wav")
    assert str(err.value) == str(jerr.value) and "pass `transcript=`" in str(err.value)
    tapi.preload_models(random_weights=True, device="cpu",
                        cfg=ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128),
                        ecfg=EngineConfig(compute_dtype="float32"))
    p = str(tmp_path / "clip.wav")
    TAU.save_wav(p, np.zeros(12000, np.float32))
    with pytest.raises(RuntimeError, match="pass `transcript=` to make_prompt"):
        tapi.make_prompt("x", p, out_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "x.npz")


def test_make_prompt_transcriptless_end_to_end(tmp_path, monkeypatch, both):
    """Transcript-less make_prompt through the port's Whisper (random
    narrow weights; a stub tokenizer stands in for HuggingFace's): the
    clip at 16 kHz → mel → encoder → detect_language → 5 sampled lanes of
    up to 150 tokens → the best lane's text → G2P → EnCodec → npz."""
    _, model, _, _, _ = both
    monkeypatch.setenv("WHISPER_MODEL_DIR", str(tmp_path))

    class Tokenizer:
        def __init__(self):
            self.seen = []

        def decode(self, ids, skip_special_tokens=True):
            self.seen.append(ids)
            return "a short test clip"

    stub = object.__new__(TWT.Transcriber)
    stub.model, stub.tokenizer = model, Tokenizer()
    monkeypatch.setitem(TWT._cached, (os.path.abspath(str(tmp_path)), "cpu"), stub)
    tapi.preload_models(random_weights=True, device="cpu",
                        cfg=ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128),
                        ecfg=EngineConfig(compute_dtype="float32"))
    p = str(tmp_path / "clip.wav")
    TAU.save_wav(p, (0.1 * np.sin(np.arange(24000) * 0.05)).astype(np.float32))
    out = tapi.make_prompt("auto", p, out_dir=str(tmp_path / "customs"))
    data = np.load(out)
    assert data["audio_tokens"].shape == (1, 75, 8) and int(data["lang_code"]) in (0, 1, 2)
    (ids,) = stub.tokenizer.seen
    assert len(ids) <= 151 and all(0 <= t < CFG.vocab and t != CFG.eot for t in ids)
