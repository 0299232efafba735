"""The AR architecture seam (engine/ar.py::ar_arch): `ar_generate_batch` is
one skeleton that names no architecture, and every decode block runs one
K-step loop (ops/decode_block.py::run_block).

CPU tests with plain PyTorch stubs: an architecture object written here,
whose prefill and step forward return fixed logits, driven through
`ar_generate_batch` (EOS forcing, each row's cap, the best sample, the
`seconds` keys, the `vallex.ar.*` spans around the stub's own), and
`run_block` against the loop written out step by step (rows done early,
rows capped early, greedy and sampled). No card is needed.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vallex_tpu_torch.config import ModelConfig
from vallex_tpu_torch.engine import ar as AR
from vallex_tpu_torch.kernels import sample_epilogue_plain
from vallex_tpu_torch.ops.decode_block import run_block

CFG = ModelConfig(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)
EOS, VOCAB, VP, K, T_GEN = 1024, 1025, 1152, 4, 32
C = float(np.log1p(np.exp(-2.0)))  # minus the logprob of every token a stub draws


def _stub_logits(tokens):
    """[..] tokens → [.., VP] f32 logits: 0 at the token, -2 at the next
    code, -1e4 elsewhere, so the argmax is the token at logprob -C."""
    out = torch.full((*tokens.shape, VP), -1e4)
    out.scatter_(-1, tokens[..., None].long(), 0.0)
    out.scatter_(-1, (tokens[..., None].long() + 1) % 1024, -2.0)
    return out


class StubAR:
    """An AR the engine does not know: `table[r, t]` is row r's token t
    (t = 0 from the prefill, t > 0 from the step forward at generated frame
    t - 1), as `_stub_logits`; the block is `run_block` around it."""

    def __init__(self, table):
        self.table = torch.as_tensor(table)
        self.rows_seen = None

    def prefill(self, model, text, lang, x_lens, prompt_lens, y_init, caps, *, K, beams,
                top_k, temperature, generator, **_):
        with record_function("stub.prefill"):
            self.rows_seen = (text.shape[0], beams)
            max_gen = torch.as_tensor(caps).repeat_interleave(beams)
            logits = _stub_logits(self.table)[:, :, :VOCAB]

            def block(tok, lp, done, sum_lp, step):
                return run_block(lambda fed, k: _stub_logits(self.table[:, step + k + 1]),
                                 tok, lp, done, sum_lp, remaining=max_gen - step, steps=K,
                                 eos=EOS, stochastic=top_k != 1, generator=generator,
                                 vocab=VOCAB, temperature=temperature, site="stub")
            return logits[:, 0], max_gen, block, lambda: {"stub_s": 1.5}


def _batch(monkeypatch, table, gen_caps, beams=1, top_k=1, x_len=5):
    """ar_generate_batch over len(gen_caps) requests with `ar_arch`
    answering StubAR(table) → (result, the stub)."""
    stub = StubAR(table)
    monkeypatch.setattr(AR, "ar_arch", lambda cfg: stub)
    R, s_text, p_audio = len(gen_caps), 8, 4
    res = AR.ar_generate_batch(
        types.SimpleNamespace(pe=torch.zeros(1)), CFG, np.ones((R, s_text), np.int32),
        np.zeros((R, s_text), np.int32), np.full(R, x_len, np.int32),
        np.full((R, p_audio - 1), EOS, np.int32), np.zeros(R, np.int32),
        np.asarray(gen_caps), generator=torch.Generator().manual_seed(0), top_k=top_k,
        temperature=1.0, s_text=s_text, p_audio=p_audio, t_gen=T_GEN, dtype=torch.float32,
        decode_steps=K, packed={"wpred": torch.zeros(VP, 1)}, beams=beams)
    return res, stub


def _table(rows, length=T_GEN + K + 1):
    """Rows of tokens: row r's token t is rows[r][t] while given, then 7."""
    out = np.full((len(rows), length), 7)
    for r, toks in enumerate(rows):
        out[r, : len(toks)] = toks
    return out


def test_skeleton_runs_an_unknown_architecture(monkeypatch):
    """Row 0 runs to its cap of 10, row 1 draws EOS at frame 2 and keeps
    feeding EOS though its logits say otherwise, row 2 stops at its cap of
    6; the loop stops once every row is done (3 blocks, not the longest
    cap's 5); the seconds hold SECONDS and the stub's own."""
    table = _table([[5, 6, 7, 8], [3, 4, EOS, 9, 9, 9], [2]])
    res, stub = _batch(monkeypatch, table, gen_caps=[10, 20, 6])
    assert stub.rows_seen == (3, 1)
    np.testing.assert_array_equal(res.gen_len, [10, 2, 6])
    for r, n in enumerate(res.gen_len):
        np.testing.assert_array_equal(res.y_gen[r, :n], table[r, :n])
        assert (res.y_gen[r, n:] == EOS).all()
    assert res.iterations == 3
    assert set(res.seconds) == {*AR.SECONDS, "ar_prefill", "stub_s"}
    assert res.seconds["stub_s"] == 1.5 and res.seconds["ar_graph_blocks"] == 0
    # every fed token's logprob while alive (EOS's too), over BOS + prompt + frames
    np.testing.assert_allclose(res.scores[:, 0], [-10 * C / 11, -C, -6 * C / 7],
                               rtol=1e-5)


def test_skeleton_caps_rows_by_the_text(monkeypatch):
    """max_gen = min(16·x_len, gen_cap, t_gen − 1): text of one phoneme
    caps every row at 16, whatever its gen_cap."""
    res, _ = _batch(monkeypatch, _table([[5], [6]]), gen_caps=[30, 12], x_len=1)
    np.testing.assert_array_equal(res.gen_len, [16, 12])


def test_skeleton_keeps_the_best_sample(monkeypatch):
    """beams = 2: the stub gets R requests and returns R·2 request-major
    rows; each request keeps the sample with the best length-normalized
    logprob: request 0 the capped one (-20C / 21 beats an EOS-ended
    sample's -C), request 1 the first of two at -C."""
    table = _table([[5, 6, EOS], [5, 6, 7, 8], [3, 3, 3, 3, 3, EOS], [4, EOS]])
    res, stub = _batch(monkeypatch, table, gen_caps=[20, 20], beams=2)
    assert stub.rows_seen == (2, 2)
    np.testing.assert_array_equal(res.gen_len, [20, 5])
    np.testing.assert_array_equal(res.y_gen[1, :6], [3, 3, 3, 3, 3, EOS])


def test_skeleton_spans_hold_the_architecture(monkeypatch):
    """The `vallex.ar.*` spans under torch.profiler, the architecture's
    own inside the prefill, a block and a read a block inside the decode,
    no capture on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, _ = _batch(monkeypatch, _table([[5], [6]]), gen_caps=[9, 5])
    spans = {}
    for e in prof.events():
        if e.name.startswith(("vallex.ar", "stub.")):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert {k: len(v) for k, v in spans.items()} == {
        "vallex.ar.prefill": 1, "stub.prefill": 1, "vallex.ar.decode": 1,
        "vallex.ar.block": res.iterations, "vallex.ar.read": res.iterations,
        "vallex.ar.finish": 1}
    (pre,), (stub,), (dec,), (fin,) = (spans[n] for n in (
        "vallex.ar.prefill", "stub.prefill", "vallex.ar.decode", "vallex.ar.finish"))
    assert pre[0] <= stub[0] and stub[1] <= pre[1]
    assert pre[1] <= dec[0] and dec[1] <= fin[0]
    assert all(dec[0] <= s and e <= dec[1]
               for s, e in spans["vallex.ar.block"] + spans["vallex.ar.read"])


def _loop_written_out(logits, tokens, logprobs, done, sum_lp, remaining, stochastic, gen):
    """The K-step bookkeeping as the TPU kernel's header states it, step by
    step, over fixed step logits [K, B, VP]."""
    fed_all = []
    for k in range(logits.shape[0]):
        d0 = done | (k >= remaining)
        fed = torch.where(d0, EOS, tokens)
        sum_lp = sum_lp + torch.where(d0, 0.0, logprobs)
        done = d0 | (fed == EOS)
        fed_all.append(fed)
        u = torch.rand(logits[k].shape, generator=gen) if stochastic else None
        tokens, logprobs = sample_epilogue_plain(logits[k], u, vocab=VOCAB, temperature=0.8,
                                                 greedy=not stochastic)
    return torch.stack(fed_all), tokens, logprobs, done, sum_lp


@pytest.mark.parametrize("stochastic", [False, True])
def test_run_block_bookkeeping(stochastic):
    """run_block with a stub forward equals the loop written out: row 0 is
    done before the block, row 1 capped after 2 steps, row 2 draws EOS at
    step 1 (and is held at EOS), row 3 runs through; logprobs summed only
    while alive; the forward sees each step's fed tokens."""
    g = torch.Generator().manual_seed(5)
    B = 4
    logits = torch.randn((K, B, VP), generator=g) * 3
    logits[0, 2, EOS] = 1e4  # row 2's step-0 draw is EOS
    tokens = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    logprobs = torch.tensor([-0.5, -1.0, -1.5, -2.0])
    done = torch.tensor([True, False, False, False])
    sum_lp = torch.tensor([-3.0, 0.0, 0.0, -1.0])
    remaining = torch.tensor([9, 2, 9, 9])
    seen = []

    def forward(fed, k):
        seen.append(fed.clone())
        return logits[k]

    r = run_block(forward, tokens, logprobs, done, sum_lp, remaining=remaining, steps=K,
                  eos=EOS, stochastic=stochastic, generator=torch.Generator().manual_seed(9),
                  vocab=VOCAB, temperature=0.8, site="stub")
    want = _loop_written_out(logits, tokens, logprobs, done, sum_lp, remaining, stochastic,
                             torch.Generator().manual_seed(9))
    for got, w in zip((r.fed, r.next_tok, r.next_logp, r.done, r.sum_logprobs), want):
        assert torch.equal(got, w)
    assert torch.equal(torch.stack(seen), r.fed) and torch.equal(r.step_logits, logits)
    assert (r.fed[:, 0] == EOS).all() and (r.fed[2:, 1] == EOS).all()
    assert (r.fed[1:, 2] == EOS).all() and r.fed[0, 2] == 13
    assert r.done.tolist() == [True, True, True, False]
    assert r.sum_logprobs[0] == -3.0
    assert torch.equal(done, torch.tensor([True, False, False, False]))  # inputs untouched
