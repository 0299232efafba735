"""Filtered sampling in the port (vallex_tpu_torch/ops/sampling.py and the
filtered mode of kernels/sample_epilogue.py, whose plain version the CPU
runs) against the JAX package's vallex_tpu/ops/sampling.py.

Kept sets must be equal element for element: the sort-based filters, the
bisection keep masks (ties at the top-k threshold all kept, the crossing
token of the nucleus kept, top_k <= 0 and top_p >= 1 disabling), and their
combination in the reference's order (top-p measured after top-k). Draws
are compared in distribution: a Monte-Carlo run of 20 000 draws must follow
JAX's filtered softmax within 4 standard errors per token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.ops import sampling as JS
from vallex_tpu_torch.kernels import sample_epilogue
from vallex_tpu_torch.ops import sampling as TS

torch.set_num_threads(1)


def _logits(seed, b, v, scale=4.0):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * scale


def _kept(filtered):
    return np.asarray(filtered) > JS.NEG_INF / 2


def jax_logsumexp(a):
    return jax.nn.logsumexp(a, axis=1, keepdims=True)


@pytest.mark.parametrize("k", [-100, 0, 1, 2, 7, 50, 1024, 1025])
def test_topk_kept_sets_equal_jax(k):
    x = _logits(k + 200, 5, 1025)
    want = _kept(JS.top_k_filter(jnp.asarray(x), jnp.int32(k)))
    np.testing.assert_array_equal(_kept(TS.top_k_filter(torch.from_numpy(x), k)), want)
    np.testing.assert_array_equal(TS.topk_keep_mask(torch.from_numpy(x), k).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(JS.topk_keep_mask(jnp.asarray(x), jnp.int32(k))), want)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_topk_ties_at_the_threshold_all_kept(k):
    x = np.asarray([[3.0, 2.0, 2.0, 2.0, 1.0, 0.0, -1.0, -2.0]], np.float32)
    want = _kept(JS.top_k_filter(jnp.asarray(x), jnp.int32(k)))
    assert want[0, 1:4].all()  # the three tied values stay together
    np.testing.assert_array_equal(_kept(TS.top_k_filter(torch.from_numpy(x), k)), want)
    np.testing.assert_array_equal(TS.topk_keep_mask(torch.from_numpy(x), k).numpy(), want)


@pytest.mark.parametrize("p", [0.05, 0.3, 0.5, 0.9, 0.99, 1.0, 1.5])
def test_topp_kept_sets_equal_jax(p):
    x = _logits(int(p * 100), 5, 1025)
    want = _kept(JS.top_p_filter(jnp.asarray(x), jnp.float32(p)))
    np.testing.assert_array_equal(_kept(TS.top_p_filter(torch.from_numpy(x), p)), want)
    np.testing.assert_array_equal(TS.topp_keep_mask(torch.from_numpy(x), p).numpy(), want)
    if p >= 1.0:
        assert want.all()
    else:  # shift-right: the token whose cumulative mass crosses p is kept
        probs = np.exp(x - x.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        for r in range(len(x)):
            kept = np.sort(probs[r][want[r]])[::-1]
            assert kept[:-1].sum() <= p < kept.sum() + 1e-6


@pytest.mark.parametrize("k,p", [(50, 0.9), (100, 0.5), (2, 0.99), (1024, 0.3),
                                 (-100, 0.9), (10, 1.0), (-1, 1.0)])
def test_combined_kept_sets_equal_jax(k, p):
    """top-k then top-p with the nucleus on the top-k-filtered
    distribution: the port's filter chain and keep mask equal JAX's."""
    x = _logits(abs(k) + int(p * 10), 4, 1025)
    chain = JS.top_p_filter(JS.top_k_filter(jnp.asarray(x), jnp.int32(k)), jnp.float32(p))
    want = _kept(chain)
    t = TS.top_p_filter(TS.top_k_filter(torch.from_numpy(x), k), p)
    np.testing.assert_array_equal(_kept(t), want)
    np.testing.assert_array_equal(TS.filtered_keep_mask(torch.from_numpy(x), k, p).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(JS.filtered_keep_mask(jnp.asarray(x), jnp.int32(k), jnp.float32(p))), want)


def test_sortable_keys_and_bisection_equal_jax():
    """The int32 keys are JAX's bit for bit (signs, zeros, the -1e30 mask
    value), and the bisection finds the same thresholds."""
    x = np.concatenate([_logits(3, 1, 61)[0], [0.0, -0.0, -1e30, 1e30, -1e9]]).astype(np.float32)
    np.testing.assert_array_equal(TS._sortable_key(torch.from_numpy(x)).numpy(),
                                  np.asarray(JS._sortable_key(jnp.asarray(x))))
    keys = TS._sortable_key(torch.from_numpy(x))[None]
    jkeys = JS._sortable_key(jnp.asarray(x))[None]
    for lim in (0, 5, 30, 65):
        t = TS._bisect_min_key(lambda v: (keys > v).sum(1, keepdim=True, dtype=torch.int32), 1, lim)
        j = JS._bisect_min_key(lambda v: jnp.sum((jkeys > v).astype(jnp.int32), axis=1,
                                                 keepdims=True), 1, lim)
        assert int(t) == int(np.asarray(j)[0, 0])


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("k,p", [(10, 0.9), (50, 0.5), (-100, 0.8), (20, 1.0)])
def test_filtered_epilogue_plain_equals_jax_arithmetic(greedy, k, p):
    """The filtered epilogue (plain version) against the TPU kernel's
    epilogue written in jnp (vallex_tpu/ops/decode_block.py:1259-1291):
    masked lanes, temperature, filtered_keep_mask, Gumbel-argmax over the
    kept scaled logits (argmax of the masked logits when greedy), the
    logprob over the kept set; tokens equal, logprobs at 1e-5."""
    R, VP, vocab, temp = 6, 1152, 1025, 0.8
    x = _logits(k + 300, R, VP, 3.0)
    u = np.random.default_rng(9).random((R, VP)).astype(np.float32)
    masked = jnp.where(jnp.arange(VP) < vocab, x, -1e30)
    scaled = masked / temp
    keep = JS.filtered_keep_mask(scaled, jnp.int32(k), jnp.float32(p))
    scaled = jnp.where(keep, scaled, -1e30)
    score = masked if greedy else scaled - jnp.log(-jnp.log(u + 1e-10) + 1e-10)
    tok = np.asarray(jnp.minimum(jnp.argmax(score, axis=1), vocab - 1))
    lp = np.asarray(scaled - jax_logsumexp(scaled))[np.arange(R), tok]
    tt, tlp, tkeep = sample_epilogue(torch.from_numpy(x), torch.from_numpy(u), vocab=vocab,
                                     temperature=temp, greedy=greedy, top_k=k, top_p=p,
                                     return_keep=True)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(tt.numpy(), tok)
    np.testing.assert_allclose(tlp.numpy(), lp, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("draw", ["epilogue", "topk_sampling"])
def test_filtered_sampling_follows_jax_filtered_softmax(draw):
    """20 000 draws of one row (top_k=8, top_p=0.8, temperature 0.9), by the
    filtered epilogue with the caller's uniforms and by topk_sampling (the
    first token's draw): every token's frequency within 4 standard errors
    (+ 1e-3) of JAX's filtered softmax, and nothing outside its kept set."""
    V, N, k, p, temp = 64, 20_000, 8, 0.8, 0.9
    x = _logits(11, 1, V, 1.5)
    ref = JS.top_p_filter(JS.top_k_filter(jnp.asarray(x) / temp, jnp.int32(k)), jnp.float32(p))
    want = np.asarray(jnp.exp(ref - jax_logsumexp(ref)))[0]
    g = torch.Generator().manual_seed(5)
    rows = torch.from_numpy(x).repeat(N, 1)
    if draw == "epilogue":
        tok, _ = sample_epilogue(rows, torch.rand(rows.shape, generator=g), vocab=V,
                                 temperature=temp, greedy=False, top_k=k, top_p=p)
    else:
        tok, _ = TS.topk_sampling(g, rows, k, p, temp)
    freq = np.bincount(tok.numpy(), minlength=V) / N
    assert freq[want == 0].sum() == 0
    assert (want > 0).sum() > 2  # the filter leaves a real choice
    se = np.sqrt(want * (1 - want) / N)
    assert np.all(np.abs(freq - want) <= 4 * se + 1e-3), np.abs(freq - want).max()


def test_topk_sampling_greedy_and_logprob_equal_jax():
    """top_k == 1 is the argmax; the logprob is taken from the filtered
    distribution, as JAX's topk_sampling does (1e-5)."""
    x = _logits(4, 3, 1025)
    for k, p in ((1, 1.0), (1, 0.5), (5, 0.9)):
        jt, jl = JS.topk_sampling(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.int32(k), jnp.float32(p), jnp.float32(0.7))
        if k == 1:
            tt, tl = TS.topk_sampling(None, torch.from_numpy(x), k, p, 0.7)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        else:  # same token → same logprob, whatever the draw
            tt = torch.from_numpy(np.array(jt)).long()
            f = TS.top_p_filter(TS.top_k_filter(torch.from_numpy(x) / 0.7, k), p)
            tl = torch.log_softmax(f, -1).gather(-1, tt[:, None])[:, 0]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
