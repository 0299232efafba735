"""The batched AR's K-step block replayed as one CUDA graph
(engine/ar.py::_block_loop, `DeviceBlocks`): every position-dependent value
of a block read from a device step counter (ops/decode_block.py with a 0-d
tensor `audio_pos`), the attention kernel's own column at a device row
(kernels/masked_attention.py with a tensor `slot`).

CPU tests at a tiny width: the device-position route against the host-int
route, bitwise, over consecutive blocks of every block kind; the loop's
in-place state run eagerly against the CPU loop; the CPU loop captures
nothing. The `card` tests need a CUDA device and skip without one; this
file imports no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_ar_graph.py -m card
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from vallex_tpu_torch import api
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.engine import ar as AR
from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
from vallex_tpu_torch.kernels import loader, masked_attention
from vallex_tpu_torch.kernels.masked_attention import attention_bounds
from vallex_tpu_torch.ops.decode_block import decode_block_fused
from vallex_tpu_torch.ops.decode_step import pack_layer_weights, quantize_weights

CFG = ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
ECFG = EngineConfig(text_buckets=(64,), audio_buckets=(256,), compute_dtype="float32")
EOS, VOCAB, K, BLOCKS = 1024, 1025, 4, 3


def _requests(n=3, seed=3):
    """n requests of 3-5 phonemes with prompts of 0-40 frames."""
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


# (weights, cache dtype, layout, sampled, extra block keywords)
KINDS = {
    "batched-bf16": ("bf16", torch.bfloat16, "batched", True, {}),
    "grouped": ("f32", torch.float32, "grouped", True, {}),
    "int8kv": ("int8", torch.float32, "batched", False, {"kv_int8": True}),
    "filtered": ("bf16", torch.bfloat16, "batched", True, {"top_k": 5, "top_p": 0.9}),
    "w8a8": ("int8", torch.bfloat16, "batched", False, {"act_quant": True}),
    "single": ("f32", torch.float32, "single", True, {}),
}


def _setup(model, kind):
    """Prefilled caches, first tokens, weights and the block keywords of
    `kind` → (tokens, caches (k, v), weights, keywords without audio_pos /
    remaining, max_gen [B], the first position)."""
    weights, dtype, layout, sampled, extra = KINDS[kind]
    extra = dict(extra)
    reqs = _requests()[:1] if layout == "single" else _requests()
    pb = AR.pad_batched_requests(reqs, EOS, 8, ECFG.text_buckets, ECFG.audio_buckets)
    R, s_text, p_audio, t_gen = len(reqs), pb["s_text"], pb["p_audio"], pb["t_gen"]
    P = s_text + p_audio
    beams = 2 if layout == "grouped" else 1
    xl, pl = torch.from_numpy(pb["x_lens"]), torch.from_numpy(pb["prompt_lens"])
    y_init = torch.cat([torch.full((R, 1), CFG.bos_id), torch.from_numpy(pb["prompt_pad"])
                        .long()], 1)
    C = P if layout == "grouped" else P + t_gen + K
    ck, cv, logits0 = AR.prefill(
        model, CFG, torch.from_numpy(pb["text"]), torch.from_numpy(pb["lang"]), xl, y_init,
        pl, s_text=s_text, p_audio=p_audio, C=C, dtype=dtype)
    lw = pack_layer_weights(model, torch.float32 if weights == "f32" else torch.bfloat16)
    if weights == "int8":
        lw = quantize_weights(pack_layer_weights(model, torch.float32))
    if extra.pop("kv_int8", False):
        ck, cv, extra["kv_scales"] = AR.int8_caches(ck, cv)
    tok = logits0.argmax(-1).to(torch.int32).repeat_interleave(beams)
    kw = dict(temperature=1.0, steps=K, s_text=s_text, vocab=VOCAB, eos=EOS,
              stochastic=sampled, **extra)
    max_gen = torch.tensor([5, 20, 30][:R]).repeat_interleave(beams)  # one row capped mid-block
    if layout == "single":
        kw.update(x_len=int(xl[0]))
        return tok, (ck[:, 0], cv[:, 0]), lw, kw, max_gen, int(pl[0]) + 1
    rep = lambda t: t.repeat_interleave(beams)  # noqa: E731
    kw.update(x_len=rep(xl), prompt_len=rep(pl), batched=True, p_audio=p_audio, beams=beams)
    if layout == "grouped":
        kw["prefix"] = (ck, cv)
        ck = torch.zeros((CFG.num_layers, R * beams, CFG.num_heads, t_gen + K, CFG.head_dim),
                         dtype=ck.dtype)
        cv = torch.zeros_like(ck)
    return tok, (ck, cv), lw, kw, max_gen, 0


def _blocks(model, kind, device_pos):
    """BLOCKS consecutive blocks from the same prefill and seed, positions
    as host ints or from a 0-d int32 counter advanced by K → (results,
    caches)."""
    tok, (ck, cv), lw, kw, max_gen, pos0 = _setup(model, kind)
    gen = torch.Generator().manual_seed(11)
    B = tok.shape[0]
    lp, done, sl = torch.zeros(B), torch.zeros(B, dtype=torch.bool), torch.zeros(B)
    counter = torch.full((), pos0, dtype=torch.int32)
    out = []
    for b in range(BLOCKS):
        pos = counter if device_pos else pos0 + b * K
        r = decode_block_fused(tok, lp, done, sl, lw, ck, cv, model.pe, audio_pos=pos,
                               remaining=max_gen - (pos - pos0), generator=gen, **kw)
        out.append(r)
        tok, lp, done, sl = r.next_tok, r.next_logp, r.done, r.sum_logprobs
        counter.add_(K)
    return out, (ck, cv)


@pytest.mark.parametrize("kind", list(KINDS))
def test_device_position_block_equals_host_position(bundle, kind):
    """decode_block_fused with audio_pos a 0-d device counter returns the
    host-int route's BlockResult bitwise, block after block (the counter
    driving PE rows, bounds, cache rows and the caps), and leaves the same
    caches, with the same uniforms drawn."""
    want, want_caches = _blocks(bundle.model, kind, False)
    got, got_caches = _blocks(bundle.model, kind, True)
    for b, (w, g) in enumerate(zip(want, got)):
        for name, a, c in zip(w._fields, w, g):
            assert a.dtype == c.dtype and torch.equal(a, c), f"block {b} {name}"
    for a, c in zip(want_caches, got_caches):
        assert torch.equal(a, c)
    assert bool(want[-1].done.any())  # the capped row ran into its cap


@pytest.mark.parametrize("cache", [torch.float32, torch.int8])
def test_masked_attention_device_slot_equals_int(cache):
    """The own-column mode with the slot as a one-element int32 tensor
    writes the same column and returns the same output as with the int."""
    torch.manual_seed(0)
    B, H, C, hd, slot = 3, 4, 40, 16, 29
    q = torch.randn(B, H, 1, hd)
    k0 = torch.randn(B, H, C, hd)
    v0 = torch.randn(B, H, C, hd)
    new = (torch.randn(B, H, 1, hd), torch.randn(B, H, 1, hd))
    scales = None
    if cache == torch.int8:
        scales = (torch.rand(H) * 0.05 + 0.01, torch.rand(H) * 0.05 + 0.01)
        k0, v0 = (torch.clamp(torch.round(t / s[None, :, None, None]), -127, 127)
                  .to(torch.int8) for t, s in zip((k0, v0), scales))
    b = attention_bounds(B, x_len=torch.tensor([3, 9, 5]), s_text=10,
                         audio_len=torch.tensor([4, 7, 2]), q_off=1, gen_lo=20,
                         gen_len=torch.tensor([5, 9, 3]))
    outs = []
    for s in (slot, torch.tensor([slot], dtype=torch.int32)):
        k, v = k0.clone(), v0.clone()
        outs.append((masked_attention(q, k, v, b, kv_scales=scales, new_kv=new, slot=s), k, v))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert not torch.equal(outs[0][1][:, :, slot], k0[:, :, slot])  # the column was written


def _block_fn(model, kind):
    """The loop's `block(tok, lp, done, sum_lp, step)` for `kind`, as
    _block_loop builds it → (block, first tokens)."""
    tok, (ck, cv), lw, kw, max_gen, _ = _setup(model, kind)
    gen = torch.Generator().manual_seed(11)

    def block(t, lp, done, sl, step):
        return decode_block_fused(t, lp, done, sl, lw, ck, cv, model.pe, audio_pos=step,
                                  remaining=max_gen - step, generator=gen, **kw)
    return block, tok


@pytest.mark.parametrize("kind", ["batched-bf16", "grouped", "int8kv"])
def test_device_blocks_run_equals_the_host_loop(bundle, kind):
    """`DeviceBlocks.run`, the body a graph captures, run eagerly BLOCKS
    times: its in-place tokens, done flags, sums, counter and y_gen columns
    equal the host-position loop's, bitwise."""
    block, tok = _block_fn(bundle.model, kind)
    RB = tok.shape[0]
    y_gen = torch.full((RB, BLOCKS * K + K), EOS, dtype=torch.int64)
    state = AR.DeviceBlocks(block, tok, torch.zeros(RB), y_gen, K)
    for _ in range(BLOCKS):
        state.run()
    assert int(state.step) == BLOCKS * K

    block, tok = _block_fn(bundle.model, kind)
    want = torch.full_like(y_gen, EOS)
    lp, done, sl = torch.zeros(RB), torch.zeros(RB, dtype=torch.bool), torch.zeros(RB)
    for b in range(BLOCKS):
        r = block(tok, lp, done, sl, b * K)
        want[:, b * K: b * K + K] = r.fed.T.long()
        tok, lp, done, sl = r.next_tok, r.next_logp, r.done, r.sum_logprobs
    assert torch.equal(y_gen, want)
    for buf, w in ((state.tok, tok), (state.lp, lp), (state.done, done), (state.sum_lp, sl)):
        assert buf.dtype == w.dtype and torch.equal(buf, w)


def test_cpu_loop_runs_eagerly(bundle, monkeypatch):
    """On CPU tensors the batched loop captures nothing: no DeviceBlocks,
    `ar_graph_blocks` and `ar_graph_capture` 0 in the batch's seconds."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU loop built a DeviceBlocks")

    monkeypatch.setattr(AR, "DeviceBlocks", refuse)
    pipe = SynthesisPipeline(bundle.model, bundle.cfg, bundle.ecfg)
    res = pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)
    assert res.ar.iterations > 0
    assert res.seconds["ar_graph_blocks"] == 0 and res.seconds["ar_graph_capture"] == 0.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card:"
                    " python -m pytest --noconftest tests/test_torch_ar_graph.py -m card")


@pytest.fixture(scope="module")
def card_bundle(card):
    return api.preload_models(random_weights=True, cfg=ModelConfig(num_layers=2),
                              ecfg=EngineConfig(text_buckets=(64,), audio_buckets=(256,)),
                              seed=7, device="cuda")


def _card_batch(bundle, monkeypatch, graphed, quantize="none", **kw):
    """One synthesize_batch on the card, the loop graphed or eager →
    (result, the loop's (y_gen, sum_logprobs, blocks, seconds) on the host,
    the batch's launch_counts)."""
    ecfg = dataclasses.replace(bundle.ecfg, quantize=quantize)
    pipe = SynthesisPipeline(bundle.model, bundle.cfg, ecfg)
    pipe.synthesize_batch(_requests(), return_wave=False, **kw)  # build and warm
    seen = {}
    loop = AR._block_loop

    def watched(*a, **k):
        out = loop(*a, **k)
        seen["loop"] = (out[0].cpu(), out[1].cpu(), out[2], out[3])
        return out

    monkeypatch.setattr(AR, "_block_loop", watched)
    monkeypatch.setattr(AR, "_graphed", lambda t: graphed)
    loader.reset_launch_counts()
    res = pipe.synthesize_batch(_requests(), return_wave=False, **kw)
    counts = collections.Counter(loader.launch_counts)
    monkeypatch.undo()
    return res, seen["loop"], counts


CARD_CASES = {
    "int8kv": dict(quantize="int8kv", top_k=1),
    "bf16": dict(top_k=1),
    "grouped": dict(best_of=2, top_k=1),
    "filtered": dict(top_k=5, top_p=0.9, seed=3),
    "sampled-int8kv": dict(quantize="int8kv", top_k=-100, seed=5),
    "sampled-bf16": dict(top_k=-100, seed=5),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_graphed_loop_equals_eager(card_bundle, monkeypatch, case):
    """The graphed loop gives bitwise the eager loop's tokens, logprob sums,
    lengths and scores (sampled cases: the same uniforms from the same
    seed, through the registered generator), the same launch counts, and
    replays every block it runs."""
    kw = CARD_CASES[case]
    eager, (ey, es, en, esec), ecounts = _card_batch(card_bundle, monkeypatch, False, **kw)
    graph, (gy, gs, gn, gsec), gcounts = _card_batch(card_bundle, monkeypatch, True, **kw)
    assert gn == en > 1
    assert torch.equal(gy, ey) and torch.equal(gs, es)
    np.testing.assert_array_equal(graph.ar.y_gen, eager.ar.y_gen)
    np.testing.assert_array_equal(graph.ar.gen_len, eager.ar.gen_len)
    np.testing.assert_array_equal(graph.ar.scores, eager.ar.scores)
    assert gcounts == ecounts
    assert gsec["ar_graph_blocks"] == gn and esec["ar_graph_blocks"] == 0
    assert gsec["ar_graph_capture"] > 0 and esec["ar_graph_capture"] == 0.0
    assert gsec["ar_wrappers"] < esec["ar_wrappers"]


@pytest.mark.card
@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_card_masked_attention_device_slot_equals_int(card, cache):
    """The kernel reads its own column's row from a device int32: the same
    output and the same written column as with the host int, bitwise, and
    a device row outside the cache writes nothing."""
    torch.manual_seed(0)
    dev = torch.device("cuda")
    B, H, C, hd, slot = 3, 16, 96, 64, 70
    q = torch.randn(B, H, 1, hd, device=dev)
    k0 = torch.randn(B, H, C, hd, device=dev)
    v0 = torch.randn(B, H, C, hd, device=dev)
    new = (torch.randn(B, H, 1, hd, device=dev), torch.randn(B, H, 1, hd, device=dev))
    scales = None
    if cache == torch.int8:
        scales = tuple(torch.rand(H, device=dev) * 0.05 + 0.01 for _ in range(2))
        k0, v0 = (torch.clamp(torch.round(t / s[None, :, None, None]), -127, 127)
                  .to(torch.int8) for t, s in zip((k0, v0), scales))
    else:
        k0, v0 = k0.to(cache), v0.to(cache)
    b = attention_bounds(B, x_len=torch.tensor([3, 9, 5], device=dev), s_text=10,
                         audio_len=torch.tensor([4, 7, 2], device=dev), q_off=1, gen_lo=20,
                         gen_len=torch.tensor([5, 40, 3], device=dev), device=dev)
    outs = []
    for s in (slot, torch.tensor([slot], dtype=torch.int32, device=dev)):
        k, v = k0.clone(), v0.clone()
        outs.append((masked_attention(q, k, v, b, kv_scales=scales, new_kv=new, slot=s), k, v))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert not torch.equal(outs[0][1][:, :, slot], k0[:, :, slot])
    k, v = k0.clone(), v0.clone()
    masked_attention(q, k, v, b, kv_scales=scales, new_kv=new,
                     slot=torch.tensor([C], dtype=torch.int32, device=dev))
    assert torch.equal(k, k0) and torch.equal(v, v0)


@pytest.mark.card
@pytest.mark.parametrize("quantize", ["none", "int8kv"])
def test_card_profiled_graph_shows_the_kernels(card_bundle, quantize):
    """Under torch.profiler a graphed batch still shows the decode kernels
    by name, each launch of every replay: the products, the attention (12
    layers' worth a step here: 2) and the epilogue, as the roofline and
    idle-share readers need them."""
    from torch.profiler import ProfilerActivity, profile

    ecfg = dataclasses.replace(card_bundle.ecfg, quantize=quantize)
    pipe = SynthesisPipeline(card_bundle.model, card_bundle.cfg, ecfg)
    pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)  # build and warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = pipe.synthesize_batch(_requests(), top_k=1, return_wave=False)
    assert res.seconds["ar_graph_blocks"] == res.ar.iterations
    names = collections.Counter(e.name.split("(")[0] for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
    steps = res.ar.iterations * max(2, ecfg.decode_steps)

    def n(sub):
        return sum(c for k, c in names.items() if sub in k)
    assert n("masked_attention_split_kernel") >= steps * card_bundle.cfg.num_layers
    assert n("gemm_tc_kernel") >= steps * (4 * card_bundle.cfg.num_layers + 1)
    assert n("sample_epilogue_draw_kernel") >= steps
