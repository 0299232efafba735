"""The batched AR's own spans and seconds (engine/ar.py::ar_generate_batch):
`vallex.ar.prefill` (with `vallex.ar.kv_quant` under int8kv),
`vallex.ar.decode` holding a `vallex.ar.block` and a `vallex.ar.read` a
block, `vallex.ar.finish`, all inside the pipeline's `vallex.ar`; the
result's `seconds` (`ar_prefill`, `ar_decode`, `ar_wait`, `ar_wrappers`)
and the kernels' `loader.launch_seconds`.

CPU tests at a tiny width through `SynthesisPipeline.synthesize_batch`
(random weights, greedy, so every request runs to its cap). The `card`
tests need a CUDA device and skip without one; this file imports no JAX,
so on the card:

    python -m pytest --noconftest tests/test_torch_ar_trace.py -m card
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vallex_tpu_torch import api
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.engine import ar as AR
from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
from vallex_tpu_torch.kernels import loader

CFG = ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
ECFG = EngineConfig(text_buckets=(64,), audio_buckets=(256,), compute_dtype="float32")
AR_SPANS = ("vallex.ar", "vallex.ar.prefill", "vallex.ar.kv_quant", "vallex.ar.decode",
            "vallex.ar.block", "vallex.ar.read", "vallex.ar.finish")


def _requests(n=3, seed=3):
    """n requests of 3-5 phonemes (caps of 48-80 frames: 6-10 blocks) with
    prompts of 0-40 frames."""
    rng = np.random.RandomState(seed)
    reqs = []
    for r in range(n):
        S, Tp = 3 + r % 3, (0, 17, 40)[r % 3]
        prompt = rng.randint(0, 1024, size=(Tp, 8)).astype(np.int32) if Tp else None
        reqs.append((rng.randint(5, 100, size=S).astype(np.int32), np.zeros(S, np.int32),
                     prompt))
    return reqs


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return api.preload_models(str(tmp_path_factory.mktemp("no_ckpt")), random_weights=True,
                              cfg=CFG, ecfg=ECFG, seed=7, device="cpu")


def _pipeline(bundle, quantize, device="cpu"):
    ecfg = dataclasses.replace(bundle.ecfg, quantize=quantize,
                               compute_dtype="float32" if device == "cpu" else "bfloat16")
    model = bundle.model if device == "cpu" else bundle.model.to(device)
    return SynthesisPipeline(model, bundle.cfg, ecfg)


def _spans(prof):
    """The AR's spans of a profiler run: name → [(start, end) µs]."""
    out = {n: [] for n in AR_SPANS}
    for e in prof.events():
        if e.name in out:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("quantize,best_of", [("none", 1), ("int8kv", 1), ("none", 2)])
def test_batch_spans_nest_in_the_ar(bundle, quantize, best_of):
    """One prefill, one decode and one finish span inside the one
    `vallex.ar`; a block and a read span a block, all inside the decode;
    the K/V quantization's span only under int8kv, inside the prefill; the
    prefill, decode and finish spans in that order and apart."""
    pipe = _pipeline(bundle, quantize)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = pipe.synthesize_batch(_requests(), best_of=best_of, top_k=1, return_wave=False)
    sp = _spans(prof)
    n = res.ar.iterations
    assert n >= 6
    assert [len(sp[s]) for s in AR_SPANS] == [
        1, 1, int(quantize == "int8kv"), 1, n, n, 1]
    (ar,), (pre,), (dec,), (fin,) = (sp[s] for s in ("vallex.ar", "vallex.ar.prefill",
                                                     "vallex.ar.decode", "vallex.ar.finish"))
    assert all(_inside(s, ar) for s in (pre, dec, fin))
    assert pre[1] <= dec[0] and dec[1] <= fin[0]
    assert all(_inside(s, dec) for s in sp["vallex.ar.block"] + sp["vallex.ar.read"])
    assert all(_inside(s, pre) for s in sp["vallex.ar.kv_quant"])
    # block i's read comes after its block and before block i + 1
    blocks, reads = sorted(sp["vallex.ar.block"]), sorted(sp["vallex.ar.read"])
    for i in range(n):
        assert blocks[i][1] <= reads[i][0]
        assert i + 1 == n or reads[i][1] <= blocks[i + 1][0]


@pytest.mark.parametrize("quantize", ["none", "int8kv", "w8a8"])
def test_batch_seconds_hold_the_ar_counters(bundle, quantize):
    """`seconds` holds the pipeline's phases and the AR's four counters,
    with 0 <= ar_wait <= ar_decode <= ar and ar_wrappers <= ar_decode -
    ar_wait; on the CPU no wrapper launches, so `launch_seconds` stays
    empty and ar_wrappers is 0."""
    pipe = _pipeline(bundle, quantize)
    loader.reset_launch_counts()
    res = pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)
    s = res.seconds
    assert set(s) == {"ar", "nar", *AR.SECONDS}
    assert res.ar.seconds == {k: s[k] for k in AR.SECONDS}
    assert 0 <= s["ar_wait"] <= s["ar_decode"] <= s["ar"]
    assert 0 < s["ar_prefill"] < s["ar"] - s["ar_decode"]
    assert s["ar_wrappers"] <= s["ar_decode"] - s["ar_wait"] + 1e-3
    assert s["ar_wrappers"] == 0.0
    assert not loader.launch_seconds and not loader.launch_counts


def test_reset_launch_counts_clears_both():
    loader.launch_counts[("k", "s")] += 2
    loader.launch_seconds[("k", "s")] += 0.5
    loader.reset_launch_counts()
    assert not loader.launch_counts and not loader.launch_seconds


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card:"
                    " python -m pytest --noconftest tests/test_torch_ar_trace.py -m card")


@pytest.fixture(scope="module")
def card_bundle(card):
    return api.preload_models(random_weights=True, cfg=ModelConfig(num_layers=2),
                              ecfg=EngineConfig(text_buckets=(64,), audio_buckets=(256,)),
                              seed=7, device="cuda")


@pytest.mark.card
@pytest.mark.parametrize("quantize", ["none", "int8kv"])
def test_card_launch_seconds_keys_match_counts(card_bundle, quantize):
    """After a batch every counted launch has its host seconds, and the
    decode loop's wrapper time lies inside its share of the loop."""
    pipe = _pipeline(card_bundle, quantize, "cuda")
    pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)  # warm
    loader.reset_launch_counts()
    res = pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)
    assert loader.launch_counts and set(loader.launch_seconds) == set(loader.launch_counts)
    assert all(loader.launch_seconds[k] >= 0 for k in loader.launch_counts)
    assert any(v > 0 for v in loader.launch_seconds.values())
    s = res.seconds
    assert 0 <= s["ar_wait"] <= s["ar_decode"] <= s["ar"]
    assert 0 < s["ar_wrappers"] <= s["ar_decode"] - s["ar_wait"]
    assert 0 < s["ar_prefill"] < s["ar"]


@pytest.mark.card
def test_card_decode_loop_reads_once_a_block(card_bundle, monkeypatch):
    """Under torch.cuda.set_sync_debug_mode("warn"), the decode loop of one
    batch synchronizes once a block (its `bool(done.all())`) and no more."""
    pipe = _pipeline(card_bundle, "int8kv", "cuda")
    pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)  # warm
    seen = {}
    loop = AR._block_loop

    def watched(*a, **kw):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = loop(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the first call also warns that the mode "does not yet detect all
        # synchronizing operations"; each detected one says this
        seen["syncs"] = sum("called a synchronizing CUDA operation" in str(w.message)
                            for w in got)
        return out

    monkeypatch.setattr(AR, "_block_loop", watched)
    res = pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)
    assert seen["syncs"] == res.ar.iterations
