"""End to end: the port's generate_audio against the JAX package's on the
CPU, in fp32, with the same weights.

Greedy (top_k=1) codes must be identical — through the port's per-token
path and through its speculative kernel path (whose wrappers take their
plain versions on the CPU): greedy speculation emits exactly the verify
pass's argmax. The waveform is compared at atol = rtol = 1e-4 (f32 on
both sides; the inverse DFT is an irfft in the port, a matmul in JAX).
"""

import jax
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.config import EngineConfig, ModelConfig

torch.set_num_threads(1)

TINY = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
BUCKETS = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512),
               compute_dtype="float32")
TEXT, PROMPT = "Hello.", "paimon"


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    jb = japi.preload_models(
        str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
        cfg=JModelConfig(**TINY), ecfg=JEngineConfig(**BUCKETS), seed=4)
    audio, text_prompt, lang_pr = japi._load_prompt(PROMPT)
    ids, langs = japi._prepare_text(jb, TEXT, text_prompt, lang_pr, "en")
    codes, wave = jb.pipeline.synthesize(ids, langs, audio, top_k=1)
    return dict(params=jax.tree.map(np.asarray, jb.params),
                vocos=jax.tree.map(np.asarray, jb.vocos_params),
                ids=ids, langs=langs, codes=codes, wave=wave)


def _port(ref, **ecfg):
    return tapi.preload_models(
        params=ref["params"], vocos_params=ref["vocos"], device="cpu",
        cfg=ModelConfig(**TINY), ecfg=EngineConfig(**BUCKETS, **ecfg))


@pytest.mark.parametrize("mode,speculative", [
    ("auto", "auto"), ("megakernel", "auto"), ("megakernel", "off"),
], ids=["auto-auto", "kernels-auto", "kernels-off"])
def test_generate_audio_greedy_matches_jax(jax_ref, mode, speculative):
    """"auto" is the per-token path on the CPU; "megakernel" runs the
    kernel path's ops (speculative, or K-step blocks with speculation off)."""
    bundle = _port(jax_ref, decode_mode=mode, speculative=speculative)
    audio, text_prompt, lang_pr = tapi._load_prompt(PROMPT)
    ids, langs = tapi._prepare_text(bundle, TEXT, text_prompt, lang_pr, "en")
    np.testing.assert_array_equal(ids, jax_ref["ids"])
    np.testing.assert_array_equal(langs, jax_ref["langs"])
    wave = tapi.generate_audio(TEXT, prompt=PROMPT, language="en", top_k=1)
    res = bundle.last
    assert res.ar.iterations > 0
    np.testing.assert_array_equal(res.codes, jax_ref["codes"])
    assert wave.shape == jax_ref["wave"].shape == (len(res.codes) * 320,)
    np.testing.assert_allclose(wave, jax_ref["wave"], atol=1e-4, rtol=1e-4)
    if mode == "megakernel":  # K frames per pass or block, not one
        assert res.ar.iterations < len(res.codes)


@pytest.mark.parametrize("mode", ["auto", "megakernel"], ids=["auto", "kernels"])
def test_generate_audio_sampled_runs(jax_ref, mode):
    """Default sampled mode (top_k=-100): speculative sampling on the
    kernel path, per-token categorical on the other; a finite waveform of
    frames · 320 samples, reproducible from the seed."""
    _port(jax_ref, decode_mode=mode)
    w1 = tapi.generate_audio(TEXT, prompt=PROMPT, language="en", seed=3)
    res = tapi._bundle.last
    w2 = tapi.generate_audio(TEXT, prompt=PROMPT, language="en", seed=3)
    assert len(w1) == len(res.codes) * 320 > 0
    assert np.isfinite(w1).all()
    np.testing.assert_array_equal(w1, w2)


@pytest.mark.parametrize("change,runs", [
    (dict(best_of=2), True), (dict(quantize="int8kv"), False), (dict(decode_steps=1), False),
], ids=["change0", "change1", "change2"])
def test_configs_outside_the_slice_raise(jax_ref, change, runs):
    """best_of=2 now runs (two greedy samples: JAX's greedy codes, the
    first sample picked); the int8 KV cache and single-step decode still
    raise, naming their ROADMAP item."""
    bundle = _port(jax_ref, **change)
    if not runs:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tapi.generate_audio(TEXT, language="en", top_k=1)
        return
    tapi.generate_audio(TEXT, prompt=PROMPT, language="en", top_k=1)
    res = bundle.last
    assert res.ar.beam_tokens.shape[0] == 2 and res.ar.best_beam == 0
    np.testing.assert_array_equal(res.codes, jax_ref["codes"])


def test_filtered_sampling_and_batches_raise(jax_ref):
    """Filtered sampling now runs, for one request and for a batch: top_k=1
    with top_p=0.5 picks the argmax, so it emits JAX's greedy codes (this
    checks the routing, not the filter) and takes each logprob over the
    kept set of one token, so the score is 0 where the unfiltered greedy
    run's is negative; top_k=5 draws finite waveforms of frames · 320
    samples, reproducible from the seed."""
    bundle = _port(jax_ref)
    tapi.generate_audio(TEXT, prompt=PROMPT, language="en", top_k=1, top_p=0.5)
    np.testing.assert_array_equal(bundle.last.codes, jax_ref["codes"])
    assert bundle.last.ar.scores.tolist() == [0.0]
    tapi.generate_audio(TEXT, prompt=PROMPT, language="en", top_k=1)
    assert bundle.last.ar.scores[0] < 0
    w1 = tapi.generate_audio(TEXT, language="en", top_k=5, seed=2)
    assert len(w1) == len(bundle.last.codes) * 320 > 0 and np.isfinite(w1).all()
    np.testing.assert_array_equal(w1, tapi.generate_audio(TEXT, language="en", top_k=5, seed=2))
    waves = tapi.generate_audio_batch([TEXT, TEXT], top_k=5, top_p=0.9, language="en")
    assert [len(w) for w in waves] == [len(c) * 320 for c, _ in bundle.last.outputs]
    assert all(len(w) and np.isfinite(w).all() for w in waves)


def test_cuda_default_without_gpu_raises(jax_ref, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.preload_models(random_weights=True, cfg=ModelConfig(**TINY))
