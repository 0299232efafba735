"""The hybrid AR (ModelConfig.ar_stack: models/granite_hybrid.py,
ops/decode_hybrid.py, kernels/ssm_step.py) at a small width: 4 layers with
attention at index 2, chunk 8, weights from the benchmark's drawer
(portbench/archs/granite4h.py), held against the plain reference
(portbench/reference/granite4h.py) in float32.

CPU: the batched prefill and the eager decode blocks against the
reference's teacher-forced logits on rows of different text and prompt
lengths; the chunked scan against the recurrence; the state after prefill
+ k steps against a prefill over the same tokens; the step kernels' plain
versions against the recurrence; grouped K/V attention against the heads
expanded; the EOS hold-off; the paths the hybrid AR rejects; VALL-E X's
tree unchanged. The `card` tests need a CUDA device and skip without one;
this file imports no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_granite_hybrid.py -m card
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.harness.spec import ROOT, load_arch
from portbench.reference import granite4h as RG
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.convert import load_tree
from vallex_tpu_torch.engine import ar as AR
from vallex_tpu_torch.engine.pipeline import SynthesisPipeline, check_config
from vallex_tpu_torch.kernels import loader, masked_attention
from vallex_tpu_torch.kernels import ssm_step as SK
from vallex_tpu_torch.kernels.masked_attention import attention_bounds
from vallex_tpu_torch.models import granite_hybrid as GH
from vallex_tpu_torch.models.vallex import VALLE, init_vallex
from vallex_tpu_torch.ops.decode_hybrid import decode_block_hybrid

ARCH = load_arch(ROOT, "granite4h")
with open(os.path.join(ROOT, "portbench", "configs", "granite-4.0-h-micro-bf16.json")) as _f:
    CONF = json.load(_f)
SMALL_AR = dict(hidden_size=64, intermediate_size=96, shared_intermediate_size=96,
                num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=16,
                mamba_d_state=16, mamba_chunk_size=8, num_hidden_layers=4,
                layer_types=["mamba", "mamba", "attention", "mamba"])
MODEL = dict(CONF["model"], d_model=32, num_heads=2, num_layers=2, ffn_dim=64,
             ar_stack=dict(CONF["model"]["ar_stack"], **SMALL_AR))
# on the card: the step kernel's head and state widths, head dim 64 throughout
CARD_MODEL = dict(CONF["model"], d_model=256, num_heads=4, num_layers=1, ffn_dim=512,
                  ar_stack=dict(CONF["model"]["ar_stack"], **dict(
                      SMALL_AR, hidden_size=256, intermediate_size=512,
                      shared_intermediate_size=512, mamba_d_head=64, mamba_d_state=128,
                      mamba_chunk_size=64)))
ECFG = EngineConfig(text_buckets=(64,), audio_buckets=(256,), compute_dtype="float32",
                    speculative="off")
EOS, VOCAB, K = 1024, 1025, 4


def _requests(n=3, seed=0):
    """Rows of 3-9 phonemes with prompts of 0, 17 and 40 frames."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(n):
        S, Tp = (3, 9, 5)[r % 3], (0, 17, 40)[r % 3]
        prompt = rng.randint(0, 1024, size=(Tp, 8)).astype(np.int32) if Tp else None
        out.append((rng.randint(5, 60, size=S).astype(np.int32), np.full(S, 2, np.int32), prompt))
    return out


def _tree(seed=5, dtype=torch.float32, device="cpu", model=MODEL):
    g = torch.Generator(device=device).manual_seed(seed)
    return ARCH.draw_tree(model, CONF["weights"], g, device, dtype)


@pytest.fixture(scope="module")
def small():
    """(program model, its ModelConfig, the reference) over one drawn tree."""
    tree = _tree()
    cfg = ARCH.program_config(MODEL)
    model = load_tree(VALLE(cfg), _clone(tree), dtype=torch.float32, device="cpu")
    return model, cfg, ARCH.reference(tree, MODEL)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _prefilled(model, cfg, reqs, t_gen_pad=K):
    pb = AR.pad_batched_requests(reqs, EOS, 8, ECFG.text_buckets, ECFG.audio_buckets)
    R = len(reqs)
    xl = torch.from_numpy(pb["x_lens"])
    pl = torch.from_numpy(pb["prompt_lens"])
    y_init = torch.cat([torch.full((R, 1), cfg.bos_id), torch.from_numpy(pb["prompt_pad"]).long()],
                       1)
    P = pb["s_text"] + pb["p_audio"]
    ck, cv, state, logits0 = GH.prefill(
        model, cfg, torch.from_numpy(pb["text"]), torch.from_numpy(pb["lang"]), xl, y_init, pl,
        s_text=pb["s_text"], p_audio=pb["p_audio"], C=P + pb["t_gen"] + t_gen_pad,
        dtype=torch.float32)
    return pb, xl, pl, ck, cv, state, logits0


def _ref_logits(ref, req, tokens):
    t, lang, p = req
    pr = torch.zeros(0, dtype=torch.long) if p is None else torch.from_numpy(p[:, 0]).long()
    return ref.ar_logits(torch.from_numpy(t).long(), torch.from_numpy(lang).long(), pr,
                         torch.as_tensor(tokens).long())


def test_config_reads_the_published_keys():
    """HybridARConfig.from_hf reads the configuration's `granitemoehybrid`
    keys: 40 layers in layer_types' order, attention at 5, 15, 25, 35."""
    h = ARCH.program_config(CONF["model"]).ar_stack
    assert h.num_layers == 40 and h.attention_layers == (5, 15, 25, 35)
    assert (h.hidden_size, h.intermediate_size, h.mamba_n_heads, h.mamba_d_head,
            h.mamba_d_state, h.mamba_chunk_size) == (2048, 8192, 64, 64, 128, 256)
    assert (h.in_proj_dim, h.conv_dim, h.head_dim) == (8512, 4352, 64)
    assert (h.embedding_multiplier, h.residual_multiplier, h.attention_multiplier,
            h.logits_scaling) == (12, 0.22, 0.015625, 8)
    for k, v in CONF["model"]["ar_stack"].items():
        assert CONF[k] == v, k  # the file's published keys and the program's agree


def test_prefill_and_decode_blocks_match_reference(small):
    """The batched prefill's first logits and every eager decode block's
    step logits equal the reference's teacher-forced logits (f32, 1e-4),
    on rows of different text and prompt lengths; the greedy tokens are
    the reference's argmax."""
    model, cfg, ref = small
    reqs = _requests()
    pb, xl, pl, ck, cv, state, logits0 = _prefilled(model, cfg, reqs)
    packed = SynthesisPipeline(model, cfg, ECFG).serving_weights()
    tok = logits0.argmax(-1).to(torch.int32)
    lp = torch.zeros(3)
    done, sum_lp = torch.zeros(3, dtype=torch.bool), torch.zeros(3)
    fed, logits = [], [logits0]
    remaining = torch.full((3,), 100)
    for blk in range(3):
        r = decode_block_hybrid(tok, lp, done, sum_lp, packed, cfg, ck, cv, state, x_len=xl,
                                prompt_len=pl, audio_pos=blk * K, remaining=remaining - blk * K,
                                temperature=1.0, steps=K, s_text=pb["s_text"],
                                p_audio=pb["p_audio"], vocab=VOCAB, eos=EOS, stochastic=False)
        fed.append(r.fed)
        logits.extend(r.step_logits[k, :, :VOCAB] for k in range(K))
        tok, lp, done, sum_lp = r.next_tok, r.next_logp, r.done, r.sum_logprobs
    fed = torch.cat(fed)  # [3K, R]
    for row, req in enumerate(reqs):
        want = _ref_logits(ref, req, fed[:, row])  # [3K + 1, 1025]
        got = torch.stack([lg[row] for lg in logits])
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert torch.equal(fed[:, row].long(), want[:-1].argmax(-1))


def test_chunked_scan_equals_recurrence():
    """ssd_chunked (chunks of 8, a ragged last chunk, Δ = 0 tail) equals the
    recurrence and the reference's quadratic form, outputs and state."""
    g = torch.Generator().manual_seed(0)
    R, L, H, P, N = 2, 29, 3, 4, 5
    x = torch.randn((R, L, H, P), generator=g)
    dt = torch.rand((R, L, H), generator=g) * 0.3
    dt[1, 20:] = 0  # row 1 ends at 20: the state passes the padding unchanged
    A = -(1 + 15 * torch.rand(H, generator=g))
    B, C = torch.randn((R, L, N), generator=g), torch.randn((R, L, N), generator=g)
    yc, Sc = GH.ssd_chunked(x, dt, A, B, C, 8)
    ys, Ss = GH.ssd_sequential(x, dt, A, B, C)
    torch.testing.assert_close(yc, ys, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(Sc, Ss, atol=1e-5, rtol=1e-5)
    _, S20 = GH.ssd_sequential(x[1:, :20], dt[1:, :20], A, B[1:, :20], C[1:, :20])
    torch.testing.assert_close(Sc[1:], S20, atol=1e-5, rtol=1e-5)
    for r in range(R):
        torch.testing.assert_close(RG.ssd_quadratic(x[r], dt[r], A, B[r], C[r]), ys[r],
                                   atol=1e-5, rtol=1e-5)


def test_state_after_prefill_and_steps(small):
    """The conv and SSM states after a prefill and k decode steps equal a
    prefill over the prompt extended by the k fed tokens."""
    model, cfg, _ = small
    reqs = _requests()
    pb, xl, pl, ck, cv, state, logits0 = _prefilled(model, cfg, reqs)
    packed = SynthesisPipeline(model, cfg, ECFG).serving_weights()
    tok = logits0.argmax(-1).to(torch.int32)
    r = decode_block_hybrid(tok, torch.zeros(3), torch.zeros(3, dtype=torch.bool), torch.zeros(3),
                            packed, cfg, ck, cv, state, x_len=xl, prompt_len=pl, audio_pos=0,
                            remaining=torch.full((3,), 100), temperature=1.0, steps=K,
                            s_text=pb["s_text"], p_audio=pb["p_audio"], vocab=VOCAB, eos=EOS,
                            stochastic=False)
    longer = []
    for row, (t, lang, p) in enumerate(reqs):
        cb0 = np.zeros((0,), np.int32) if p is None else p[:, 0]
        ext = np.concatenate([cb0, r.fed[:, row].numpy().astype(np.int32)])
        longer.append((t, lang, np.repeat(ext[:, None], 8, 1)))
    *_, state2, _ = _prefilled(model, cfg, longer)
    torch.testing.assert_close(state.conv, state2.conv, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state.ssm, state2.ssm, atol=1e-5, rtol=1e-5)


def test_step_plain_versions_equal_recurrence():
    """ssm_step_plain is one step of the recurrence (with the D term and the
    silu(z) gate); conv_step_plain the causal convolution's next output;
    rms_norm_rows_plain and swiglu_rows_plain their formulas."""
    g = torch.Generator().manual_seed(1)
    M, H, P, N = 3, 4, 8, 16
    inner, Cd = H * P, H * P + 2 * N
    zd = torch.randn((M, inner + Cd + H), generator=g)
    xbc = torch.randn((M, Cd), generator=g)
    S0 = torch.randn((M, H, P, N), generator=g)
    dt_bias, A_log, D = (torch.randn(H, generator=g) for _ in range(3))
    S = S0.clone()
    y = SK.ssm_step_plain(xbc, zd, S, dt_bias, A_log, D, z_off=0, dt_off=inner + Cd)
    x = xbc[:, :inner].view(M, 1, H, P)
    B, C = xbc[:, None, inner: inner + N], xbc[:, None, inner + N:]
    delta = F.softplus(zd[:, None, inner + Cd:] + dt_bias)
    ys, Ss = GH.ssd_sequential(x, delta, -torch.exp(A_log), B, C, S0=S0)
    torch.testing.assert_close(S, Ss, atol=1e-5, rtol=1e-5)
    want = (ys[:, 0] + D[:, None] * x[:, 0]) * F.silu(zd[:, :inner].view(M, H, P))
    torch.testing.assert_close(y, want.reshape(M, inner), atol=1e-5, rtol=1e-5)
    st = torch.randn((M, 3, Cd), generator=g)
    w, b = torch.randn((Cd, 4), generator=g), torch.randn(Cd, generator=g)
    seq = torch.cat([st, zd[:, None, inner: inner + Cd]], 1)  # [M, 4, Cd]
    want = F.silu(F.conv1d(seq.transpose(1, 2), w[:, None], b, groups=Cd))[..., 0]
    st2 = st.clone()
    torch.testing.assert_close(SK.conv_step_plain(zd, st2, w, b, x_off=inner), want,
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(st2, seq[:, 1:])
    xr, gn = torch.randn((M, 64), generator=g), torch.randn(64, generator=g)
    torch.testing.assert_close(SK.rms_norm_rows_plain(xr, gn, 1e-5),
                               GH.rms_norm(xr, gn, 1e-5))
    torch.testing.assert_close(SK.swiglu_rows_plain(xr), F.silu(xr[:, :32]) * xr[:, 32:])


def test_grouped_kv_attention_equals_expanded_heads():
    """masked_attention with each K/V head's G query heads as its G queries
    (q_off 0) equals the attention of every query head over its K/V head
    repeated, each head alone."""
    g = torch.Generator().manual_seed(2)
    B, Hkv, G, C, hd = 3, 2, 4, 40, 16
    q = torch.randn((B, Hkv, G, hd), generator=g)
    k, v = torch.randn((B, Hkv, C, hd), generator=g), torch.randn((B, Hkv, C, hd), generator=g)
    xl, pl = torch.tensor([3, 5, 2]), torch.tensor([4, 0, 7])
    bounds = attention_bounds(B, x_len=xl, s_text=8, audio_len=pl + 1, q_off=0, gen_lo=24,
                              gen_len=torch.tensor([3, 3, 3]))
    got = masked_attention(q, k, v, bounds)
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (k, v))
    b1 = attention_bounds(B, x_len=xl, s_text=8, audio_len=pl + 1, q_off=1, gen_lo=24,
                          gen_len=torch.tensor([3, 3, 3]))
    want = masked_attention(q.reshape(B, Hkv * G, 1, hd), kx, vx, b1)
    torch.testing.assert_close(got.reshape(B, Hkv * G, 1, hd), want)


def test_eos_held_off():
    """The drawn weights keep EOS far below every code in the reference's
    logits, so every request runs to its cap."""
    tree = _tree(seed=11)
    ref = ARCH.reference(tree, MODEL)
    t, lang, p = _requests()[1]
    lg = _ref_logits(ref, (t, lang, p), torch.randint(0, 1024, (30,)))
    assert float((lg[:, :1024].max(-1).values - lg[:, 1024]).min()) > 20


def test_batch_runs_to_caps(small):
    """synthesize_batch on the CPU: well-formed codes, every request at its
    cap, the hybrid's seconds (the scans, the state's bytes)."""
    model, cfg, _ = small
    res = SynthesisPipeline(model, cfg, ECFG).synthesize_batch(_requests(), top_k=1, seed=1,
                                                              return_wave=False)
    caps = [min(16 * len(t), 256 - (0 if p is None else len(p)) - 2) for t, _, p in _requests()]
    assert [len(c) for c, _ in res.outputs] == caps
    assert set(res.seconds) == {"ar", "nar", *AR.HYBRID_SECONDS}
    assert res.seconds["ar_scan"] > 0
    assert res.seconds["ar_state_bytes"] == GH.state_bytes(cfg, 3)


REJECTED = {
    "int8": (dict(quantize="int8"), "quantize"),
    "w8a8": (dict(quantize="w8a8"), "quantize"),
    "int8kv": (dict(quantize="int8kv"), "quantize"),
    "speculative": (dict(speculative="on"), "speculative"),
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_pipeline_rejects_engine_paths(small, case):
    model, cfg, _ = small
    kw, word = REJECTED[case]
    with pytest.raises(ValueError, match=word):
        SynthesisPipeline(model, cfg, dataclasses.replace(ECFG, **kw))


def test_rejects_best_of(small):
    model, cfg, _ = small
    with pytest.raises(ValueError, match="best_of"):
        SynthesisPipeline(model, cfg, ECFG).synthesize_batch(_requests(), best_of=2)
    with pytest.raises(ValueError, match="best_of"):
        check_config(ECFG, best_of=3, cfg=cfg)


def test_rejects_single_request_synthesize(small):
    model, cfg, _ = small
    t, lang, p = _requests()[1]
    pipe = SynthesisPipeline(model, cfg, ECFG)
    with pytest.raises(ValueError, match="single-request synthesize"):
        pipe.synthesize(t, lang, p)
    with pytest.raises(ValueError, match="single-request synthesize"):
        pipe.synthesize_batch([(t, lang, p)])


def test_rejects_filtered_sampling(small):
    model, cfg, _ = small
    with pytest.raises(ValueError, match="top-k / top-p filtering 5 / 1.0"):
        SynthesisPipeline(model, cfg, ECFG).synthesize_batch(_requests(), top_k=5)


def test_vallex_tree_unchanged():
    """ModelConfig() names no hybrid stack, and VALL-E X's tree keeps its
    leaves (AR positions included)."""
    cfg = ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
    assert cfg.ar_stack is None and cfg.ar_width == 64
    tree = init_vallex(cfg, torch.Generator().manual_seed(0))
    assert "ar_text_position" in tree and "self_attn" in tree["ar_decoder"]["layers"]
    load_tree(VALLE(cfg), tree, dtype=torch.float32, device="cpu")


def test_random_init_builds_the_hybrid():
    """init_vallex with an ar_stack draws the hybrid tree, which VALLE loads."""
    cfg = ARCH.program_config(MODEL)
    tree = init_vallex(cfg, torch.Generator().manual_seed(0))
    assert "ar_text_position" not in tree and "mamba" in tree["ar_decoder"]
    m = load_tree(VALLE(cfg), tree, dtype=torch.float32, device="cpu")
    assert m.ar_text_embedding.weight.shape == (2048, 64)
    assert m.nar_text_embedding.weight.shape == (2048, 32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card:"
                    " python -m pytest --noconftest tests/test_torch_granite_hybrid.py -m card")


@pytest.mark.card
def test_card_step_kernels_equal_plain(card):
    """ssm_step_kernel at the cell's widths (64 heads of 64 × 128, 48 rows),
    conv_step_kernel, rms_norm_rows_kernel and swiglu_rows_kernel against
    their plain versions on the card, twice bitwise; the states in place."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    M, H, P, N = 48, 64, 64, 128
    inner, Cd = H * P, H * P + 2 * N
    zd = torch.randn((M, inner + Cd + H), generator=g, device=dev)
    xbc = torch.randn((M, Cd), generator=g, device=dev)
    S0 = torch.randn((M, H, P, N), generator=g, device=dev)
    dt_bias = torch.randn(H, generator=g, device=dev) - 3
    A_log = torch.log(1 + 15 * torch.rand(H, generator=g, device=dev))
    D = torch.ones(H, device=dev)
    outs = []
    for _ in range(2):
        S = S0.clone()
        outs.append((SK.ssm_step(xbc, zd, S, dt_bias, A_log, D, z_off=0, dt_off=inner + Cd), S))
    Sp = S0.clone()
    yp = SK.ssm_step_plain(xbc, zd, Sp, dt_bias, A_log, D, z_off=0, dt_off=inner + Cd)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][1], Sp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[0][0], yp, atol=1e-4, rtol=1e-4)
    st = torch.randn((M, 3, Cd), generator=g, device=dev)
    w, b = torch.randn((Cd, 4), generator=g, device=dev), torch.randn(Cd, generator=g, device=dev)
    st_k, st_p = st.clone(), st.clone()
    torch.testing.assert_close(SK.conv_step(zd, st_k, w, b, x_off=inner),
                               SK.conv_step_plain(zd, st_p, w, b, x_off=inner),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(st_k, st_p)
    x, gn = torch.randn((M, 2048), generator=g, device=dev), torch.randn(2048, device=dev)
    torch.testing.assert_close(SK.rms_norm_rows(x, gn, 1e-5), SK.rms_norm_rows_plain(x, gn, 1e-5),
                               atol=1e-5, rtol=1e-5)
    x2 = torch.randn((M, 2 * 8192), generator=g, device=dev)
    torch.testing.assert_close(SK.swiglu_rows(x2), SK.swiglu_rows_plain(x2), atol=1e-5, rtol=1e-5)


def _card_batch(pipe, monkeypatch, graphed, **kw):
    pipe.synthesize_batch(_requests(4), return_wave=False, **kw)  # build and warm
    seen = {}
    loop = AR._block_loop

    def watched(*a, **k):
        out = loop(*a, **k)
        seen["loop"] = (out[0].cpu(), out[1].cpu(), out[2], out[3])
        return out

    monkeypatch.setattr(AR, "_block_loop", watched)
    monkeypatch.setattr(AR, "_graphed", lambda t: graphed)
    loader.reset_launch_counts()
    res = pipe.synthesize_batch(_requests(4), return_wave=False, **kw)
    counts = collections.Counter(loader.launch_counts)
    monkeypatch.undo()
    return res, seen["loop"], counts


@pytest.mark.card
@pytest.mark.parametrize("top_k", [1, -100])
def test_card_graphed_hybrid_equals_eager(card, monkeypatch, top_k):
    """The hybrid block replayed as a CUDA graph gives bitwise the eager
    loop's tokens, logprob sums and lengths, the same launch counts (the
    step kernel's among them), and replays every block it runs."""
    tree = _tree(seed=9, dtype=torch.bfloat16, device="cuda", model=CARD_MODEL)
    cfg = ARCH.program_config(CARD_MODEL)
    model = load_tree(VALLE(cfg), tree, dtype=torch.bfloat16, device="cuda")
    pipe = SynthesisPipeline(model, cfg, dataclasses.replace(ECFG, compute_dtype="bfloat16"))
    eager, (ey, es, en, esec), ec = _card_batch(pipe, monkeypatch, False, top_k=top_k, seed=4)
    graph, (gy, gs, gn, gsec), gc = _card_batch(pipe, monkeypatch, True, top_k=top_k, seed=4)
    assert gn == en > 1
    assert torch.equal(gy, ey) and torch.equal(gs, es)
    np.testing.assert_array_equal(graph.ar.gen_len, eager.ar.gen_len)
    assert gc == ec and gc[("ssm_step", "decode_block_hybrid")] > 0
    assert gsec["ar_graph_blocks"] == gn and esec["ar_graph_blocks"] == 0
