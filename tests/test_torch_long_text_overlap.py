"""Dispatch and fetch as two steps (engine/pipeline.py: synthesize_async,
PendingSynthesis) and long text overlapped on them (api.py), against the
JAX package in fp32 on the CPU at toy width (d 64, 4 heads, 2 + 2 layers).

- synthesize_async(...).result() gives bitwise the codes and wave of the
  AR → NAR → Vocos sequence run step by step, and synthesize() the same.
- Long text in both modes gives the JAX package's greedy codes
  (vallex_tpu/api.py's double-buffered loops), through the public entry
  points and through the per-sentence loop on the kernel path (the route
  the card's fixed-prompt check drives), batch and stream alike.
- A recording pipeline shows the order: sentence i + 1 is dispatched
  before sentence i is fetched when i's pre-drawn coin is at or above 0.5,
  after it when below; the stream dispatches sentence 0 on the calling
  thread and hands out its wave before the worker starts sentence 1;
  closing the stream early, or an error in the loop, leaves no live
  worker.
- PhaseTimer and trace on the CPU.

Tolerances: codes, waves and orders exactly.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from vallex_tpu import api as japi
from vallex_tpu.config import EngineConfig as JEngineConfig
from vallex_tpu.config import ModelConfig as JModelConfig
from vallex_tpu_torch import api as tapi
from vallex_tpu_torch.codec.vocos import HOP, vocos_decode
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.engine import pipeline as P
from vallex_tpu_torch.engine.ar import bucket
from vallex_tpu_torch.engine.nar import nar_generate
from vallex_tpu_torch.utils import profiling

torch.set_num_threads(1)

DIMS = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
ENGINE = dict(text_buckets=(64, 128), audio_buckets=(128, 256, 512), compute_dtype="float32")
TEXT = "Hello there. Good morning to you. See you soon. Take care."
SEED = 1  # coins 0.417, 0.720, 0.0001, 0.302: slide, keep, slide, slide
WORKER = "vallex-long-text"


def _coins(n, seed=SEED):
    rng = np.random.RandomState(seed)
    return [rng.rand() for _ in range(n)]


@pytest.fixture(scope="module")
def jax_long(tmp_path_factory):
    jb = japi.preload_models(str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
                             cfg=JModelConfig(**DIMS), ecfg=JEngineConfig(**ENGINE, top_k=1),
                             seed=4)
    out = {}
    orig = japi.codes_to_wave
    try:
        for mode in ("fixed-prompt", "sliding-window"):
            japi.codes_to_wave = lambda b, c, mode=mode: out.__setitem__(mode, c) or orig(b, c)
            japi.generate_audio_from_long_text(TEXT, "paimon", language="en", mode=mode,
                                               seed=SEED)
    finally:
        japi.codes_to_wave = orig
    return dict(params=jax.tree.map(np.asarray, jb.params),
                vocos=jax.tree.map(np.asarray, jb.vocos_params), codes=out)


def _port(ref, **engine):
    return tapi.preload_models(params=ref["params"], vocos_params=ref["vocos"], device="cpu",
                               cfg=ModelConfig(**DIMS),
                               ecfg=EngineConfig(**ENGINE, **{"top_k": 1, **engine}))


class _Recorder:
    """Wraps bundle.pipeline.synthesize_async: logs ("dispatch", i) when a
    dispatch returns and ("fetch", i) when a handle's first result() call
    starts; `before(i)` runs before dispatch i."""

    def __init__(self, bundle, before=None):
        self.log, self.codes, self.n = [], {}, 0
        self.orig, self.before = bundle.pipeline.synthesize_async, before
        bundle.pipeline.synthesize_async = self.dispatch
        self.lock = threading.Lock()

    def dispatch(self, *a, **k):
        i = self.n
        self.n += 1
        if self.before:
            self.before(i)
        h = self.orig(*a, **k)
        self.log.append(("dispatch", i))
        rec = self

        class Handle:
            def result(self):
                with rec.lock:
                    if i not in rec.codes:
                        rec.log.append(("fetch", i))
                        rec.codes[i] = None
                res = h.result()
                rec.codes[i] = res.codes
                return res
        return Handle()

    def all_codes(self):
        return np.concatenate([self.codes[i] for i in sorted(self.codes)], axis=0)


def _workers():
    return [t for t in threading.enumerate() if t.name == WORKER and t.is_alive()]


# ---------------------------------------------------------------------------
# synthesize_async
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, -100], ids=["greedy", "sampled"])
def test_result_equals_the_steps_in_turn(jax_long, top_k):
    """result(): bitwise the codes and wave of the AR's tokens put through
    nar_generate, shift_out_prompt and vocos_decode one after the other,
    the same as synthesize(); its seconds carry every phase."""
    bundle = _port(jax_long, top_k=top_k)
    pipe, cfg, e = bundle.pipeline, bundle.cfg, bundle.ecfg
    audio, text_prompt, lang_pr = tapi._load_prompt("paimon")
    ids, langs = tapi._prepare_text(bundle, "Good morning.", text_prompt, lang_pr, "en")
    res = pipe.synthesize_async(ids, langs, audio, seed=3).result()
    again = pipe.synthesize(ids, langs, audio, seed=3)
    assert set(res.seconds) == {"ar", "nar", "vocos", "enqueue", "sync"}

    S, Tp, gl = len(ids), len(audio), res.ar.gen_len
    s_text = bucket(S, e.text_buckets)
    t_audio = bucket(min(Tp + 1 + 16 * S + 1, e.audio_buckets[-1]), e.audio_buckets,
                     granularity=512)
    text = torch.zeros((1, s_text), dtype=torch.int64)
    text[0, :S] = torch.from_numpy(ids.astype(np.int64))
    lang = torch.zeros((1, s_text), dtype=torch.int64)
    lang[0, :S] = torch.from_numpy(langs.astype(np.int64))
    codes_pad = torch.zeros((1, t_audio, 8), dtype=torch.int64)
    codes_pad[0, :Tp] = torch.from_numpy(audio.astype(np.int64))
    with torch.inference_mode():
        codes_in = P.assemble_nar_input(torch.from_numpy(res.ar.tokens).long(), codes_pad,
                                        t_audio, cfg.eos_id)
        codes = P.shift_out_prompt(nar_generate(bundle.model, cfg, text, lang, S, codes_in,
                                                Tp + gl, Tp, dtype=torch.float32), Tp, gl)
        wave = vocos_decode(bundle.vocos, codes, bandwidth_id=2, t_len=gl)
    np.testing.assert_array_equal(res.codes, codes[0, :gl].numpy())
    np.testing.assert_array_equal(res.wave, wave[0, :gl * HOP].numpy())
    np.testing.assert_array_equal(again.codes, res.codes)
    np.testing.assert_array_equal(again.wave, res.wave)
    assert res.codes.shape == (gl, 8) and gl > 0


def test_result_is_fetched_once():
    """Two result() calls (a stream's worker and its reader) give the same
    SynthesisResult; the handle drops its device tensors."""
    bundle = tapi.preload_models(random_weights=True, device="cpu", cfg=ModelConfig(**DIMS),
                                 ecfg=EngineConfig(**ENGINE, top_k=1), seed=2)
    ids, langs = tapi._prepare_text(bundle, "Hi.", np.zeros(0, np.int32), None, "en")
    h = bundle.pipeline.synthesize_async(ids, langs, return_wave=False)
    a = h.result()
    assert h.result() is a and a.wave is None and h._codes is None


# ---------------------------------------------------------------------------
# Long text against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["api", "loop-kernels"])
@pytest.mark.parametrize("mode", ["fixed-prompt", "sliding-window"])
def test_long_text_codes_equal_jax(jax_long, mode, route):
    """Greedy long text, 4 sentences with both kinds of coin: the port's
    codes equal the JAX package's through generate_audio_from_long_text
    (per-token decode), and through the per-sentence loop on the kernel
    path (_long_text_codes, which the card's fixed-prompt check drives)."""
    if route == "api":
        bundle = _port(jax_long)
        rec = _Recorder(bundle)
        wave = tapi.generate_audio_from_long_text(TEXT, "paimon", language="en", mode=mode,
                                                  seed=SEED)
        assert wave.shape == (len(jax_long["codes"][mode]) * 320,)
        got = rec.all_codes()
    else:
        bundle = _port(jax_long, decode_mode="megakernel")
        got = np.concatenate(tapi._long_text_codes(
            bundle, tapi.split_text_into_sentences(TEXT), tapi._load_prompt("paimon"), "en",
            "no-accent", mode, None, SEED), axis=0)
    np.testing.assert_array_equal(got, jax_long["codes"][mode])


@pytest.mark.parametrize("mode", ["fixed-prompt", "sliding-window"])
def test_stream_codes_equal_jax(jax_long, mode):
    """The stream (worker thread, per-token decode) yields one wave per
    sentence, of the JAX package's codes."""
    bundle = _port(jax_long)
    rec = _Recorder(bundle)
    waves = list(tapi.stream_audio_from_long_text(TEXT, "paimon", language="en", mode=mode,
                                                  seed=SEED))
    want = jax_long["codes"][mode]
    np.testing.assert_array_equal(rec.all_codes(), want)
    assert [len(w) for w in waves] == [len(rec.codes[i]) * 320 for i in range(4)]
    assert not _workers()


# ---------------------------------------------------------------------------
# Dispatch order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fixed-prompt", "sliding-window"])
def test_batch_loop_dispatches_next_before_fetch(jax_long, mode):
    """generate_audio_from_long_text: sentence i + 1's dispatch comes
    before sentence i's fetch when i's coin is >= 0.5 (every sentence in
    fixed-prompt mode), after it when below."""
    bundle = _port(jax_long)
    rec = _Recorder(bundle)
    tapi.generate_audio_from_long_text(TEXT, "paimon", language="en", mode=mode, seed=SEED)
    coins = _coins(4) if mode == "sliding-window" else [1.0] * 4
    at = {ev: k for k, ev in enumerate(rec.log)}
    assert len(rec.log) == 8
    for i in range(3):
        overlapped = at[("dispatch", i + 1)] < at[("fetch", i)]
        assert overlapped == (coins[i] >= 0.5), (i, coins[i], rec.log)
    if mode == "sliding-window":
        assert {c >= 0.5 for c in coins[:3]} == {True, False}


def test_stream_yields_sentence_before_next_dispatch_returns(jax_long):
    """The stream hands out sentence 0's wave before sentence 1's dispatch
    (its AR) returns: dispatch 1 waits for the reader to hold wave 0, which
    a loop that dispatches i + 1 before yielding i would never let
    happen."""
    bundle = _port(jax_long)
    got0 = threading.Event()
    seen = {}

    def before(i):
        if i == 1:
            seen["wave0_first"] = got0.wait(timeout=60)

    rec = _Recorder(bundle, before)
    stream = tapi.stream_audio_from_long_text(TEXT, "paimon", language="en",
                                              mode="fixed-prompt", seed=SEED)
    first = next(stream)
    got0.set()
    rest = list(stream)
    assert seen["wave0_first"] and len(first) > 0 and len(rest) == 3
    assert rec.log.index(("fetch", 0)) < rec.log.index(("dispatch", 1))


def test_stream_runs_sentence_zero_on_the_calling_thread(jax_long):
    """Sentence 0 is dispatched on the thread that reads the stream, as a
    loop of one sentence at a time would; the later sentences on the
    worker."""
    bundle = _port(jax_long)
    threads = {}
    _Recorder(bundle, lambda i: threads.__setitem__(i, threading.current_thread().name))
    waves = list(tapi.stream_audio_from_long_text(TEXT, "paimon", language="en",
                                                  mode="sliding-window", seed=SEED))
    assert len(waves) == 4
    assert threads == {0: threading.current_thread().name, 1: WORKER, 2: WORKER, 3: WORKER}


def test_stream_starts_worker_after_first_wave(jax_long):
    """Until the reader asks for wave 1, only sentence 0 was dispatched and
    no worker runs: the first wave shares the host with no other thread.
    Wave 1 is dispatched on the worker once asked for."""
    bundle = _port(jax_long)
    rec = _Recorder(bundle)
    stream = tapi.stream_audio_from_long_text(TEXT, "paimon", language="en",
                                              mode="fixed-prompt", seed=SEED)
    assert len(next(stream)) > 0
    assert rec.n == 1 and not _workers()
    assert len(next(stream)) > 0 and rec.n >= 2
    stream.close()
    assert not _workers()


def test_stream_closed_early_leaves_no_worker(jax_long):
    """Closing the generator after the first wave ends the loop: no live
    worker, and not every sentence was dispatched."""
    bundle = _port(jax_long)
    rec = _Recorder(bundle)
    stream = tapi.stream_audio_from_long_text(TEXT, "paimon", language="en",
                                              mode="fixed-prompt", seed=SEED)
    assert len(next(stream)) > 0
    stream.close()
    assert not _workers()
    assert rec.n < 4


def test_stream_error_reaches_reader_and_stops_worker(jax_long):
    """An error in the sentence loop (here the third dispatch) reaches the
    reader after the waves before it, and the worker is gone."""
    bundle = _port(jax_long)

    def before(i):
        if i == 2:
            raise RuntimeError("dispatch 2 failed")

    _Recorder(bundle, before)
    stream = tapi.stream_audio_from_long_text(TEXT, "paimon", language="en",
                                              mode="fixed-prompt", seed=SEED)
    waves = []
    with pytest.raises(RuntimeError, match="dispatch 2 failed"):
        for w in stream:
            waves.append(w)
    assert len(waves) == 2 and not _workers()


# ---------------------------------------------------------------------------
# PhaseTimer, trace
# ---------------------------------------------------------------------------

def test_phase_timer_cpu_and_report(jax_long, tmp_path):
    """The pipeline's timer collects ar / nar / vocos / sync (the tail's
    device phases take the host clock on the CPU); trace() writes a chrome
    trace holding the pipeline's spans."""
    bundle = _port(jax_long)
    timer = bundle.pipeline.timer
    timer.reset()
    with profiling.trace(str(tmp_path / "tr")):
        tapi.generate_audio("Hello.", "paimon", language="en")
    res = bundle.last
    rep = timer.report()
    assert set(rep) == {"ar", "nar", "vocos", "sync"} and timer.counts["ar"] == 1
    assert rep["nar"] == res.seconds["nar"] and rep["sync"] == res.seconds["sync"]
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = f.read()
    assert all(f'"vallex.{s}"' in trace for s in ("ar", "nar", "vocos"))

    span_timer = profiling.PhaseTimer()
    with span_timer.device_phase("x") as span:
        pass
    assert span.seconds() >= 0 and span.seconds() == span_timer.report()["x"]
    assert span_timer.counts["x"] == 1
    assert os.path.isdir(tmp_path / "tr")
