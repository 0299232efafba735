"""The port's prompt-making stack against the JAX package on the CPU, in
fp32: EnCodec (vallex_tpu_torch/codec/encodec.py) at its fixed widths on a
1 s clip, WAV I/O (utils/audio.py), the fbank (codec/fbank.py),
`api.make_prompt` and `cli make-prompt`.

Tolerances: latents and waveforms within 1e-4 of their scale; RVQ codes
equal, or where a code differs, the JAX residual's distances to the two
codes within 1e-5 of their magnitude (a near tie); `rvq_decode` and the
converted trees bitwise; WAV reading bitwise against the JAX package's
Python path where no resampling happens (its C++ decoder reads 24-bit PCM
as silence), and against its load_wav with its library where it does (the
port resamples through its own native runtime, the same arithmetic); the
fbank within 1e-4.
"""

import json
import os
import struct
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu import native as jnative
from vallex_tpu.codec import encodec as JEC
from vallex_tpu.codec import fbank as JFB
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu.utils import audio as JAU
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch import cli as tcli
from vallex_tpu_torch.codec import encodec as TEC
from vallex_tpu_torch.codec import fbank as TFB
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import params_from_jax
from vallex_tpu_torch.utils import audio as TAU

torch.set_num_threads(2)

TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
BUCKETS = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512), compute_dtype="float32")
TIE = 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def enc():
    params = JEC.init_encodec(jax.random.PRNGKey(0))
    return params, params_from_jax(_np(params))


@pytest.fixture(scope="module")
def clip():
    """1 s at 24 kHz: two tones and noise."""
    t = np.arange(24000) / 24000.0
    rng = np.random.RandomState(0)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
            + 0.02 * rng.randn(24000)).astype(np.float32)


def _scale_close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def codes_agree(port, ref, latents, codebooks, tie=TIE):
    """Codes equal, or at a frame's first differing stage both codes are
    within `tie` (relative) of the nearest distance ‖e‖² − 2 r·e of the
    reference's residual; later stages of that frame follow their own
    residuals and are not compared. → frames that part at a tie."""
    port, ref = np.asarray(port).reshape(-1, 8), np.asarray(ref).reshape(-1, 8)
    lat = np.asarray(latents, np.float64).reshape(-1, latents.shape[-1])
    cb = np.asarray(codebooks, np.float64)
    parted = 0
    for t in np.nonzero(np.any(port != ref, axis=1))[0]:
        q = int(np.argmax(port[t] != ref[t]))
        r = lat[t] - sum(cb[j][ref[t, j]] for j in range(q))
        d = (cb[q] ** 2).sum(-1) - 2 * cb[q] @ r
        a, b = d[ref[t, q]], d[port[t, q]]
        assert abs(a - b) <= tie * max(abs(a), abs(b), 1.0), (t, q, a, b)
        parted += 1
    return parted


# ---------------------------------------------------------------------------
# EnCodec
# ---------------------------------------------------------------------------

def test_encode_latent_matches_jax(enc, clip):
    params, model = enc
    want = np.asarray(JEC.encode_latent(params, jnp.asarray(clip[None])))
    got = TEC.encode_latent(model, torch.from_numpy(clip[None])).numpy()
    assert got.shape == want.shape == (1, 75, 128)
    _scale_close(got, want)


def test_rvq_encode_and_decode_match_jax(enc, clip):
    """rvq_encode under the tie rule on the same latents; rvq_decode
    bitwise on the JAX package's codes."""
    params, model = enc
    lat = np.array(JEC.encode_latent(params, jnp.asarray(clip[None])))
    want = np.array(JEC.rvq_encode(params, jnp.asarray(lat)))
    got = TEC.rvq_encode(model, torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == (1, 75, 8)
    codes_agree(got, want, lat, params["codebooks"])
    q_want = np.asarray(JEC.rvq_decode(params, jnp.asarray(want)))
    q_got = TEC.rvq_decode(model, torch.from_numpy(want).long()).numpy()
    np.testing.assert_array_equal(q_got, q_want)


def test_decode_wave_matches_jax(enc, clip):
    """The decoder's transposed convs: a kernel not un-flipped from the JAX
    tree shows here."""
    params, model = enc
    codes = np.array(JEC.encode(params, jnp.asarray(clip[None])))
    lat = np.array(JEC.rvq_decode(params, jnp.asarray(codes)))
    want = np.asarray(JEC.decode_wave(params, jnp.asarray(lat)))
    got = TEC.decode_wave(model, torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == (1, 24000)
    _scale_close(got, want)
    _scale_close(TEC.decode(model, torch.from_numpy(codes).long()).numpy(), want)


@pytest.mark.parametrize("samples", [320, 1000, 2239], ids=["1-frame", "4-frames", "7-frames"])
def test_encode_short_clips_match_jax(enc, samples):
    """encode's right zero-pad to a multiple of 320 and the causal reflect
    pad where it is longer than the input (under 7 frames the final conv's
    pad of 6 reflects more than once, as jnp.pad does)."""
    params, model = enc
    wav = (0.2 * np.random.RandomState(samples).randn(1, samples)).astype(np.float32)
    pad = np.pad(wav, ((0, 0), (0, (-samples) % 320)))  # what JEC.encode does first
    lat = np.array(JEC.encode_latent(params, jnp.asarray(pad)))
    want = np.asarray(JEC.rvq_encode(params, jnp.asarray(lat)))
    got = TEC.encode(model, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, -(-samples // 320), 8)
    _scale_close(TEC.encode_latent(model, torch.from_numpy(pad)).numpy(), lat)
    codes_agree(got, want, lat, params["codebooks"])


@pytest.mark.parametrize("n", [1, 2, 3, 9])
def test_reflect_pad_matches_jnp(n):
    x = np.arange(n, dtype=np.float32)[None, None]
    for pad in range(0, 3 * n + 8):
        want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (pad, 0)), mode="reflect"))
        np.testing.assert_array_equal(TEC._reflect_left(torch.from_numpy(x), pad).numpy(), want)


def _pip_state_dict(tree, seed=0):
    """An encodec_model_24khz state dict (module paths, torch layouts) from
    a JAX-layout tree: weight-normed convs (weight_g, weight_v) except the
    shortcuts, which carry a plain weight, to reach both branches."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(prefix, p, tr=False, plain=False):
        base = f"{prefix}.convtr.convtr" if tr else f"{prefix}.conv.conv"
        w = np.asarray(p["w"])
        w = np.transpose(w[::-1], (1, 2, 0)) if tr else np.transpose(w, (2, 1, 0))
        if plain:
            sd[f"{base}.weight"] = w.copy()
        else:
            sd[f"{base}.weight_v"] = w.copy()
            sd[f"{base}.weight_g"] = rng.uniform(0.5, 2.0, (w.shape[0], 1, 1)).astype(np.float32)
        sd[f"{base}.bias"] = np.asarray(p["b"])

    def lstm(prefix, layers):
        for i, p in enumerate(layers):
            sd[f"{prefix}.lstm.weight_ih_l{i}"] = np.asarray(p["wi"]).T.copy()
            sd[f"{prefix}.lstm.weight_hh_l{i}"] = np.asarray(p["wh"]).T.copy()
            sd[f"{prefix}.lstm.bias_ih_l{i}"] = np.asarray(p["bi"])
            sd[f"{prefix}.lstm.bias_hh_l{i}"] = np.asarray(p["bh"])

    e, d = tree["encoder"], tree["decoder"]
    conv("encoder.model.0", e["init"])
    for s, st in enumerate(e["stages"]):
        i = 1 + 3 * s
        conv(f"encoder.model.{i}.block.1", st["res_conv1"])
        conv(f"encoder.model.{i}.block.3", st["res_conv2"])
        conv(f"encoder.model.{i}.shortcut", st["shortcut"], plain=True)
        conv(f"encoder.model.{i + 2}", st["down"])
    lstm("encoder.model.13", e["lstm"])
    conv("encoder.model.15", e["final"])
    conv("decoder.model.0", d["init"])
    lstm("decoder.model.1", d["lstm"])
    for s, st in enumerate(d["stages"]):
        i = 3 + 3 * s
        conv(f"decoder.model.{i}", st["up"], tr=True)
        conv(f"decoder.model.{i + 1}.block.1", st["res_conv1"])
        conv(f"decoder.model.{i + 1}.block.3", st["res_conv2"])
        conv(f"decoder.model.{i + 1}.shortcut", st["shortcut"], plain=True)
    conv("decoder.model.15", d["final"])
    for q in range(8):
        sd[f"quantizer.vq.layers.{q}._codebook.embed"] = np.asarray(tree["codebooks"][q])
    return sd


def test_convert_encodec_state_dict_matches_jax(enc):
    """Every leaf of the port's conversion bitwise the JAX package's
    (weight norm fused, transposed kernels flipped)."""
    params, _ = enc
    sd = _pip_state_dict(_np(params))
    want = jax.tree_util.tree_leaves_with_path(_np(JEC.convert_encodec_state_dict(sd)))
    got = jax.tree_util.tree_leaves_with_path(TEC.convert_encodec_state_dict(sd))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# WAV I/O and fbank
# ---------------------------------------------------------------------------

def _write(path, raw, sr, width, ch):
    with wave.open(path, "wb") as f:
        f.setnchannels(ch)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(raw)


@pytest.mark.parametrize("width,ch", [(2, 1), (2, 2), (3, 1), (3, 2), (1, 1), (4, 2)],
                         ids=["16bit", "16bit-stereo", "24bit", "24bit-stereo", "8bit",
                              "32bit-stereo"])
def test_load_wav_matches_jax(tmp_path, monkeypatch, width, ch):
    """At 24 kHz (no resampling) bitwise the JAX package's Python path (its
    C++ decoder is switched off: it reads 24-bit PCM as silence)."""
    raw = np.random.RandomState(width * ch).randint(0, 256, 4800 * ch * width)
    p = str(tmp_path / "x.wav")
    _write(p, raw.astype(np.uint8).tobytes(), 24000, width, ch)
    monkeypatch.setattr(jnative, "load_wav", lambda path: None)
    want, sr_j = JAU.load_wav(p)
    got, sr = TAU.load_wav(p)
    assert sr == sr_j == 24000 and got.dtype == want.dtype == np.float32
    assert got.shape == (4800,) and np.array_equal(got, want)


@pytest.fixture(scope="module")
def jlib():
    """The JAX package's native library: its load_wav resamples through it."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library does not build here")


@pytest.mark.parametrize("sr", [16000, 44100])
def test_load_wav_resamples_as_jax(tmp_path, jlib, sr):
    """Another rate: 16-bit samples through the native resampler to 24 kHz,
    bitwise the JAX package's load_wav with its library."""
    pcm = (np.random.RandomState(sr).randn(sr // 2) * 3000).astype(np.int16)
    p = str(tmp_path / "x.wav")
    _write(p, pcm.tobytes(), sr, 2, 1)
    got, out_sr = TAU.load_wav(p)
    want, _ = JAU.load_wav(p)
    assert out_sr == 24000 and got.shape == want.shape == (12000,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _write_float(path, wav, sr):
    """Mono float32 samples as an IEEE-float RIFF/WAVE (format tag 3)."""
    data = np.asarray(wav, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    body = b"WAVEfmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body) + len(data)) + body + data)


def test_save_wav_bytes_equal_jax(tmp_path, clip):
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    JAU.save_wav(a, clip * 4)  # clipped at ±1
    TAU.save_wav(b, clip * 4)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_extract_fbank_matches_jax(clip):
    """Within 1e-4 of the features' scale of the JAX package's (its DFT is
    an f32 product, which rounds quiet bins more than the port's FFT), and
    within 1e-5 of that scale of a float64 numpy reference."""
    wav = clip[None]
    want = np.asarray(JFB.extract_fbank(jnp.asarray(wav)))
    got = TFB.extract_fbank(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 93, 100)
    _scale_close(got, want)
    fb = TFB.mel_filterbank().numpy()
    _scale_close(fb, np.asarray(JFB.mel_filterbank()))
    pad = (TFB.N_FFT - TFB.HOP) // 2
    x = np.pad(wav[0].astype(np.float64), pad, mode="reflect")
    idx = np.arange(93)[:, None] * TFB.HOP + np.arange(TFB.N_FFT)[None]
    spec = np.fft.rfft(x[idx] * np.hanning(TFB.N_FFT + 1)[:-1], axis=-1)
    ref = np.log(np.maximum(np.sqrt(np.abs(spec) ** 2 + 1e-9) @ fb.astype(np.float64), 1e-5))
    _scale_close(got[0], ref, rel=1e-5)


# ---------------------------------------------------------------------------
# make_prompt
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundles(tmp_path_factory, enc):
    """The JAX package's bundle from a vallex-jax.npz, given the EnCodec
    tree of `enc`, and the port's with the same trees (its Vocos random)."""
    from vallex_tpu.models import vallex as JV
    from vallex_tpu.utils.checkpoint import save_native

    from vallex_tpu_torch.codec.vocos import init_vocos

    d = tmp_path_factory.mktemp("ckpt")
    params = _np(JV.init_vallex(jax.random.PRNGKey(4), JModelConfig(**TINY)))
    save_native(str(d / "vallex-jax.npz"), params)
    jb = japi.preload_models(str(d), cfg=JModelConfig(**TINY), ecfg=JEngineConfig(**BUCKETS))
    jb.encodec_params = enc[0]
    tb = tapi.preload_models(params=params, vocos_params=init_vocos(torch.Generator()),
                             encodec_params=_np(enc[0]), device="cpu",
                             cfg=ModelConfig(**TINY), ecfg=EngineConfig(**BUCKETS))
    return jb, tb


@pytest.mark.parametrize("kind", ["24k-int16", "16k-int16", "44k-float32"])
def test_make_prompt_matches_jax(tmp_path, request, bundles, clip, kind):
    """The same npz as vallex_tpu.api.make_prompt: keys, dtypes, shapes,
    text ids and language equal, codes under the tie rule; each package's
    prompt loads in the other's _load_prompt; generate_audio runs with it.
    The clip: 1 s of 16-bit PCM at 24 or 16 kHz, or of float32 at 44.1 kHz
    (the last two resampled, which needs the JAX package's library)."""
    jb, tb = bundles
    p = str(tmp_path / "clip.wav")
    if kind == "24k-int16":
        TAU.save_wav(p, clip)
    else:
        request.getfixturevalue("jlib")
        sr = 16000 if kind == "16k-int16" else 44100
        x = np.interp(np.arange(sr) * 24000 / sr, np.arange(24000), clip).astype(np.float32)
        if kind == "16k-int16":
            TAU.save_wav(p, x, sr)
        else:
            _write_float(p, x, sr)
    japi._bundle, tapi._bundle = jb, tb
    jout = japi.make_prompt("v", p, transcript="Hello there.", out_dir=str(tmp_path / "j"))
    tout = tapi.make_prompt("v", p, transcript="Hello there.", out_dir=str(tmp_path / "t"))
    J, T = np.load(jout), np.load(tout)
    assert sorted(J.files) == sorted(T.files) == ["audio_tokens", "lang_code", "text_tokens"]
    for k in J.files:
        assert J[k].dtype == T[k].dtype and J[k].shape == T[k].shape, k
    assert T["audio_tokens"].shape == (1, 75, 8)
    np.testing.assert_array_equal(T["text_tokens"], J["text_tokens"])
    assert int(T["lang_code"]) == int(J["lang_code"]) == 2
    wav, _ = JAU.load_wav(p)
    lat = np.asarray(JEC.encode_latent(jb.encodec_params, jnp.asarray(wav[None])))
    codes_agree(T["audio_tokens"], J["audio_tokens"], lat, jb.encodec_params["codebooks"])
    for load, out in ((japi._load_prompt, tout), (tapi._load_prompt, jout)):
        audio, text, lang = load(out)
        assert audio.shape == (75, 8) and len(text) == T["text_tokens"].shape[1] and lang == "en"
    wave_out = tapi.generate_audio("Hi.", prompt=tout, top_k=1, max_duration=0.3)
    assert wave_out.ndim == 1 and len(wave_out) > 0 and np.isfinite(wave_out).all()


def test_make_prompt_rejects_long_audio_and_missing_codec(tmp_path, bundles):
    """Over 15 s: the JAX package's ValueError; a bundle without EnCodec
    weights raises as the JAX package does."""
    _, tb = bundles
    tapi._bundle = tb
    p = str(tmp_path / "long.wav")
    TAU.save_wav(p, np.zeros(24000 * 16, np.float32))
    with pytest.raises(ValueError, match="Prompt too long, expect length below 15 seconds"):
        tapi.make_prompt("x", p, transcript="hi", out_dir=str(tmp_path))
    tapi.preload_models(params=_np(bundles[0].params), device="cpu", cfg=ModelConfig(**TINY),
                        ecfg=EngineConfig(**BUCKETS), checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="EnCodec weights unavailable"):
        tapi.make_prompt("x", p, transcript="hi", out_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "x.npz")


def test_cli_make_prompt(tmp_path, capsys, clip):
    """python -m vallex_tpu_torch.cli make-prompt on the CPU with random
    weights: writes the npz and prints its path."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": TINY, "engine": {k: list(v) if isinstance(v, tuple)
                                                          else v for k, v in BUCKETS.items()}}))
    p = str(tmp_path / "clip.wav")
    TAU.save_wav(p, clip[:12000])
    out_dir = tmp_path / "customs"
    assert tcli.main(["make-prompt", "me", p, "--transcript", "Hello.", "--out-dir",
                      str(out_dir), "--device", "cpu", "--random-weights", "--config",
                      str(cfg), "--checkpoints", str(tmp_path / "none")]) == 0
    assert f"wrote {out_dir / 'me.npz'}" in capsys.readouterr().out
    data = np.load(out_dir / "me.npz")
    assert data["audio_tokens"].shape == (1, 38, 8) and data["audio_tokens"].dtype == np.int64
