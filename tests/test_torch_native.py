"""The port's native host runtime (vallex_tpu_torch/native.py, built from
native/vallex_native.cpp by g++ on the CPU) against the JAX package's
(vallex_tpu/native.py) and against its plain versions; and the port's
`convert_vocos_state_dict` against the JAX package's.

Tolerances: token ids equal; decoded samples bitwise (integer PCM: the
JAX package's Python path, from which its own C++ decoder departs for
24-bit and stereo 32-bit; float: its library); the resampler bitwise the
JAX library's and within 1e-6 of the port's numpy formula; converted
Vocos trees bitwise; their waveforms within 1e-5 of the JAX package's.
Cases that need the JAX package's library skip where it does not build.
"""

import os
import struct
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu import native as jnative
from vallex_tpu.codec import vocos as JVC
from vallex_tpu.utils import audio as JAU
from vallex_tpu_torch import native
from vallex_tpu_torch.codec import vocos as TVC
from vallex_tpu_torch.convert import load_tree
from vallex_tpu_torch.frontend.cleaners import cje_cleaners
from vallex_tpu_torch.frontend.symbols import symbols
from vallex_tpu_torch.frontend.tokenizer import PhonemeTokenizer, lookup_ids
from vallex_tpu_torch.utils import audio as TAU

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = [(16000, 24000), (22050, 24000), (44100, 24000), (48000, 24000), (24000, 16000),
         (8000, 24000), (44101, 24000), (24000, 48000), (11025, 22050)]


@pytest.fixture(scope="module")
def jlib():
    """The JAX package's native library (built by its own Makefile)."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library does not build here")


def write_pcm(path, raw: bytes, sr: int, width: int, ch: int):
    """Interleaved little-endian PCM samples `width` bytes wide, `ch` channels."""
    with wave.open(path, "wb") as f:
        f.setnchannels(ch)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(raw)


def write_riff(path, samples: np.ndarray, sr: int, fmt: int, extensible=False):
    """samples [n, channels] (their dtype's bytes as written) in a RIFF/WAVE
    of format tag `fmt` (1 PCM, 3 IEEE float), or WAVE_FORMAT_EXTENSIBLE
    with `fmt` as its sub-format; a LIST chunk before the data."""
    n_ch, width = samples.shape[1], samples.dtype.itemsize
    fmt_body = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, n_ch, sr,
                           sr * n_ch * width, n_ch * width, 8 * width)
    if extensible:
        guid = struct.pack("<H", fmt) + bytes.fromhex("000000001000800000aa00389b71")
        fmt_body += struct.pack("<HHI", 22, 8 * width, 0) + guid
    data = samples.astype(samples.dtype.newbyteorder("<")).tobytes()
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"LIST" + struct.pack("<I", 4) + b"INFO"
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


# ---------------------------------------------------------------------------
# tokenize
# ---------------------------------------------------------------------------

def _phonemes(case: str) -> str:
    if case == "unknown":
        return "with:unknown%chars_ŋ😀é"
    if case == "random":
        rng = np.random.RandomState(0)
        pool = [c for c in symbols if len(c) == 1] + list("%:#😀中́")
        return "".join(pool[i] for i in rng.randint(0, len(pool), 500))
    text = {"en": "[EN]Hello world, this is a test.[EN]",
            "zh": "[ZH]你好，欢迎使用语音合成。[ZH]",
            "ja": "[JA]こんにちは、今日はいい天気ですね。[JA]"}[case]
    return cje_cleaners(text)[0].replace(" ", "_")


CASES = ["en", "zh", "ja", "unknown", "random"]


@pytest.mark.parametrize("case", CASES)
def test_tokenize_matches_lookup(case):
    s = _phonemes(case)
    ids = native.tokenize(s)
    assert ids.dtype == np.int32 and ids.tolist() == lookup_ids(s) and len(ids) == len(s)
    assert PhonemeTokenizer().encode(s) == lookup_ids(s)


@pytest.mark.parametrize("case", CASES)
def test_tokenize_matches_jax(jlib, case):
    s = _phonemes(case)
    np.testing.assert_array_equal(native.tokenize(s), jnative.tokenize(s))


def test_tokenize_refuses_nul():
    with pytest.raises(ValueError, match="NUL"):
        native.tokenize("a\0b")


# ---------------------------------------------------------------------------
# load_wav: the decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 3, 4], ids=["8bit", "16bit", "24bit", "32bit"])
@pytest.mark.parametrize("ch", [1, 2], ids=["mono", "stereo"])
def test_load_wav_int_is_jax_python_path(tmp_path, monkeypatch, width, ch):
    """At 24 kHz bitwise the JAX package's Python path and the port's plain
    decoder (the JAX package's C++ decoder reads 24-bit as silence)."""
    raw = np.random.RandomState(10 * width + ch).randint(0, 256, (2400, ch * width))
    p = str(tmp_path / "x.wav")
    write_pcm(p, raw.astype(np.uint8).tobytes(), 24000, width, ch)
    got, sr = TAU.load_wav(p)
    plain, sr_p = TAU.read_wav_plain(p)
    monkeypatch.setattr(jnative, "load_wav", lambda path: None)
    want, sr_j = JAU.load_wav(p)
    assert sr == sr_j == 24000 and sr_p == 24000 and got.dtype == np.float32
    assert got.shape == (2400,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got.view(np.int32), plain.view(np.int32))


@pytest.mark.parametrize("ch", [3, 8, 9])
def test_load_wav_many_channels_is_plain(tmp_path, ch):
    """numpy's mean over 8 or more channels sums pairwise: bitwise too."""
    pcm = np.random.RandomState(ch).randint(-2**31, 2**31, (1200, ch)).astype(np.int32)
    p = str(tmp_path / "x.wav")
    write_pcm(p, pcm.tobytes(), 24000, 4, ch)
    got, _ = native.load_wav(p)
    plain, _ = TAU.read_wav_plain(p)
    assert np.array_equal(got.view(np.int32), plain.view(np.int32))


@pytest.mark.parametrize("sr", [24000, 44100])
@pytest.mark.parametrize("ch", [1, 2], ids=["mono", "stereo"])
def test_load_wav_float_matches_jax(tmp_path, jlib, sr, ch):
    """IEEE float32 (the stdlib `wave` refuses it): the JAX package's
    load_wav with its library, resampling included."""
    x = (np.random.RandomState(sr + ch).randn(sr // 4, ch) * 0.3).astype(np.float32)
    p = str(tmp_path / "f.wav")
    write_riff(p, x, sr, 3)
    got, out_sr = TAU.load_wav(p)
    want, _ = JAU.load_wav(p)
    assert out_sr == 24000 and got.shape == want.shape == (6000,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    raw, raw_sr = native.load_wav(p)
    assert raw_sr == sr
    assert np.array_equal(raw, (x.astype(np.float64).sum(1) / ch).astype(np.float32))


def test_load_wav_extensible(tmp_path):
    """WAVE_FORMAT_EXTENSIBLE read by its sub-format (PCM: the plain
    decoder's samples, float: float's)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2400, 2) * 0.3
    p = str(tmp_path / "d.wav")
    write_riff(p, x.astype(np.float32), 24000, 3, extensible=True)
    got, _ = native.load_wav(p)
    assert np.array_equal(got, (x.astype(np.float32).astype(np.float64).sum(1) / 2)
                          .astype(np.float32))
    pcm = rng.randint(-32768, 32768, (2400, 2)).astype(np.int16)
    write_riff(p, pcm, 24000, 1, extensible=True)
    got, _ = native.load_wav(p)
    q = str(tmp_path / "plain.wav")
    write_pcm(q, pcm.tobytes(), 24000, 2, 2)
    assert np.array_equal(got, TAU.read_wav_plain(q)[0])


def test_load_wav_rejects(tmp_path):
    """A truncated, non-RIFF, data-less, A-law or 64-bit float file raises
    a ValueError naming the path; a missing one FileNotFoundError."""
    pcm = np.random.RandomState(4).randint(-32768, 32768, (2400, 1)).astype(np.int16)
    good = str(tmp_path / "good.wav")
    write_pcm(good, pcm.tobytes(), 16000, 2, 1)
    blob = open(good, "rb").read()
    cases = {"truncated": blob[:-100], "not-riff": b"OggS" + blob[4:],
             "no-data": blob[:36], "random": np.random.RandomState(5).bytes(400)}
    for name, body in cases.items():
        p = str(tmp_path / f"{name}.wav")
        with open(p, "wb") as f:
            f.write(body)
        with pytest.raises(ValueError, match=f"{name}.wav"):
            TAU.load_wav(p)
    alaw, f64 = str(tmp_path / "alaw.wav"), str(tmp_path / "f64.wav")
    write_riff(alaw, pcm.astype(np.uint8), 8000, 6)
    write_riff(f64, pcm / 32768.0, 8000, 3)
    for p in (alaw, f64):
        with pytest.raises(ValueError, match="sample format"):
            TAU.load_wav(p)
    with pytest.raises(FileNotFoundError):
        TAU.load_wav(str(tmp_path / "missing.wav"))


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------

def _signal(n, seed):
    t = np.arange(n) / 8000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.random.RandomState(seed).randn(n)).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_resample_is_jax_library(jlib, sr_in, sr_out):
    x = _signal(sr_in // 2, sr_in)
    got = native.resample(x, sr_in, sr_out)
    want = jnative.resample(x, sr_in, sr_out)
    assert got.dtype == np.float32 and got.shape == want.shape == ((len(x) * sr_out) // sr_in,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_resample_matches_formula(sr_in, sr_out):
    x = _signal(sr_in // 2 + 7, sr_in + 1)
    got = native.resample(x, sr_in, sr_out)
    want = TAU.resample_plain(x, sr_in, sr_out)
    assert got.shape == want.shape == ((len(x) * sr_out) // sr_in,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resample_identity():
    x = _signal(1000, 1)
    assert np.array_equal(native.resample(x, 24000, 24000), x)
    assert np.array_equal(TAU.resample_plain(x, 24000, 24000), x)
    with pytest.raises(ValueError):
        native.resample(np.zeros((10, 2), np.float32), 16000, 24000)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

_CHILD = """
import sys
from pathlib import Path
from vallex_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
native.library()
print(native.library_path(), native.tokenize("abc").tolist())
"""


def test_two_processes_build_once(tmp_path):
    """Two fresh interpreters started together on an empty build directory
    both load the one library the lock let one of them build."""
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(build)], cwd=str(tmp_path),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert outs[0] == outs[1] and outs[0].endswith(str(lookup_ids("abc")))
    assert sorted(f.name for f in build.iterdir()) == [
        ".lock", os.path.basename(outs[0].split()[0])]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no compiler: the build raises with
    the compiler's message, and the tokenizer and load_wav raise with it."""
    bad = tmp_path / "vallex_native.cpp"
    bad.write_text('extern "C" int vn_tokenize( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed .*error:"):
        native.library()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        PhonemeTokenizer().encode("abc")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        TAU.load_wav(str(tmp_path / "any.wav"))
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        native.library()


# ---------------------------------------------------------------------------
# convert_vocos_state_dict
# ---------------------------------------------------------------------------

def vocos_state_dict(seed: int) -> dict:
    """A random state dict with the upstream checkpoint's keys and torch
    layouts."""
    rng = np.random.RandomState(seed)
    D, I, C, K = TVC.DIM, TVC.INTERMEDIATE_DIM, TVC.INPUT_CHANNELS, 7

    def r(*shape, scale=0.02):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd = {"backbone.embed.weight": r(D, C, K), "backbone.embed.bias": r(D),
          "backbone.norm.scale.weight": 1 + r(TVC.NUM_BANDWIDTHS, D),
          "backbone.norm.shift.weight": r(TVC.NUM_BANDWIDTHS, D),
          "backbone.final_layer_norm.weight": 1 + r(D),
          "backbone.final_layer_norm.bias": r(D),
          "head.out.weight": r(TVC.N_FFT + 2, D), "head.out.bias": r(TVC.N_FFT + 2)}
    for i in range(TVC.NUM_LAYERS):
        p = f"backbone.convnext.{i}"
        sd.update({f"{p}.dwconv.weight": r(D, 1, K), f"{p}.dwconv.bias": r(D),
                   f"{p}.norm.scale.weight": 1 + r(TVC.NUM_BANDWIDTHS, D),
                   f"{p}.norm.shift.weight": r(TVC.NUM_BANDWIDTHS, D),
                   f"{p}.pwconv1.weight": r(I, D), f"{p}.pwconv1.bias": r(I),
                   f"{p}.pwconv2.weight": r(D, I), f"{p}.pwconv2.bias": r(D),
                   f"{p}.gamma": r(D, scale=0.1)})
    for q in range(TVC.NUM_CODEBOOKS):
        sd[f"feature_extractor.encodec.quantizer.vq.layers.{q}._codebook.embed"] = r(
            TVC.CODEBOOK_SIZE, C, scale=1.0)
    return sd


@pytest.fixture(scope="module")
def vocos_trees():
    sd = vocos_state_dict(7)
    return sd, JVC.convert_vocos_state_dict(sd), TVC.convert_vocos_state_dict(sd)


def test_convert_vocos_matches_jax(vocos_trees):
    """Bitwise the JAX package's tree, from numpy and from torch leaves."""
    sd, jtree, ttree = vocos_trees
    from_torch = TVC.convert_vocos_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jl = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jtree))[0]
    for tree in (ttree, from_torch):
        tl = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [k for k, _ in tl] == [k for k, _ in jl]
        for (k, t), (_, j) in zip(tl, jl):
            assert t.dtype == np.float32 and t.shape == j.shape, k
            assert np.array_equal(t, j), k


def test_converted_vocos_decode_matches_jax(vocos_trees):
    _, jtree, ttree = vocos_trees
    vocos = load_tree(TVC.Vocos(), ttree, dtype=torch.float32, device="cpu")
    codes = np.random.RandomState(8).randint(0, TVC.CODEBOOK_SIZE, (1, 24, 8))
    j = np.asarray(JVC.vocos_decode(jax.tree.map(jnp.asarray, jtree),
                                    jnp.asarray(codes, jnp.int32), 2))
    with torch.inference_mode():
        t = TVC.vocos_decode(vocos, torch.from_numpy(codes), 2).numpy()
    assert t.shape == j.shape == (1, 24 * TVC.HOP) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
