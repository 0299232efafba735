"""The sampling epilogue's selection algorithm (kernels/sample_epilogue.cu) on
the CPU, through its plain versions in kernels/sample_epilogue.py:

- `radix_topk_key_plain`, the kernel's 4 x 8-bit radix select of the top-k
  threshold, gives the same key as the JAX package's 32-step bisection
  (`_bisect_min_key`) and so the same kept set as its `topk_keep_mask`;
- `topp_kept_sorted_plain`, the kernel's nucleus over sorted candidates
  (exclusive prefix sums over groups of equal keys), gives the kept set of
  the JAX `topp_keep_mask` (top-p alone) and, after the radix select, of
  `filtered_keep_mask` (top-k then top-p), on the rows where no token's
  mass above lies within 1e-6 of top_p (the f32 sums run in another order).

Rows, made with numpy from a seed, V = 1152 lanes with the lanes >= 1025
at -1e30: Gaussian logits, ties at the k-th value, an all-equal row, -0.0
beside +0.0, and Gaussian logits at temperature 0.7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.ops import sampling as JS
from vallex_tpu_torch.kernels.sample_epilogue import (
    CAND_CAP, radix_topk_key_plain, topp_kept_sorted_plain,
)
from vallex_tpu_torch.ops.sampling import NEG_INF, _sortable_key

torch.set_num_threads(1)

V, VOCAB = 1152, 1025
KS = (1, 2, 50, 64, 65, 200, 1025, 1152)
TOP_PS = (0.05, 0.5, 0.9, 0.99)
KINDS = ("gauss", "ties", "equal", "signed_zero", "temperature")


def _rows(k: int, seed: int = 0) -> np.ndarray:
    """One row of each KIND, [len(KINDS), V] f32 (ties: 5 more lanes take the
    row's k-th largest real logit)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(len(KINDS), V) * 3).astype(np.float32)
    real = x[1, :VOCAB]
    kth = np.sort(real)[::-1][min(k, VOCAB) - 1]
    x[1, rng.choice(VOCAB, 5, replace=False)] = kth
    x[2, :] = 0.25
    x[3, :40] = 0.0
    x[3, 40:80] = -0.0
    x[:, VOCAB:] = -1e30
    x[4] /= np.float32(0.7)
    return x


_topk_jax = jax.jit(JS.topk_keep_mask)
_topp_jax = jax.jit(JS.topp_keep_mask)
_filtered_jax = jax.jit(JS.filtered_keep_mask)


@jax.jit
def _bisect_jax(logits, k):
    keys = JS._sortable_key(logits)
    return JS._bisect_min_key(
        lambda v: jnp.sum((keys > v).astype(jnp.int32), axis=1, keepdims=True),
        logits.shape[0], k - 1)[:, 0]


def _clear_rows(f: np.ndarray, top_p: float) -> np.ndarray:
    """[R] bool: rows of f (the filtered logits top-p measures) with no token
    whose mass strictly above lies within 1e-6 of top_p."""
    p = np.exp(f.astype(np.float64) - f.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    out = []
    for fr, pr in zip(f, p):
        order = np.argsort(-fr, kind="stable")
        fs, ps = fr[order], pr[order]
        excl = np.concatenate([[0.0], np.cumsum(ps)[:-1]])
        first = np.searchsorted(-fs, -fs, side="left")  # first of each group of equal values
        out.append(not np.any(np.abs(excl[first] - top_p) <= 1e-6))
    return np.array(out)


@pytest.mark.parametrize("k", KS)
def test_radix_select_key_equals_jax_bisection(k):
    x = _rows(k)
    keys = _sortable_key(torch.from_numpy(x))
    tau = radix_topk_key_plain(keys, k)
    ref = np.asarray(_bisect_jax(jnp.asarray(x), jnp.full((len(KINDS), 1), k, jnp.int32)))
    np.testing.assert_array_equal(tau.numpy(), ref)
    keep = (keys >= tau[:, None]).numpy()
    np.testing.assert_array_equal(
        keep, np.asarray(_topk_jax(jnp.asarray(x), jnp.full((len(KINDS), 1), k, jnp.int32))))
    # ties at the k-th value all stay: at least k kept, every copy of the k-th value
    assert (keep.sum(1) >= min(k, V)).all()
    assert keep[1][x[1] == x[1][(keys[1] == tau[1]).numpy()][0]].all()


@pytest.mark.parametrize("top_p", TOP_PS)
def test_sorted_topp_alone_equals_jax(top_p):
    x = _rows(50)
    t = torch.from_numpy(x)
    kept = topp_kept_sorted_plain(_sortable_key(t), torch.softmax(t, -1),
                                  torch.ones_like(t, dtype=torch.bool), top_p).numpy()
    ref = np.asarray(_topp_jax(jnp.asarray(x), jnp.full((len(KINDS), 1), top_p, jnp.float32)))
    clear = _clear_rows(x, top_p)
    assert clear.sum() >= 3
    np.testing.assert_array_equal(kept[clear], ref[clear])


@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("k", KS)
def test_radix_then_sorted_topp_equals_jax_filtered(k, top_p):
    """The kernel's filtered path: tau_k by radix select, the top-k-filtered
    row at -1e9, the candidates (keys >= tau_k) sorted for the nucleus (the
    kernel sorts when there are at most CAND_CAP of them and bisects above;
    both give this kept set)."""
    x = _rows(k)
    t = torch.from_numpy(x)
    keys = _sortable_key(t)
    keep_k = keys >= radix_topk_key_plain(keys, k)[:, None]
    f = torch.where(keep_k, t, NEG_INF)
    kept = (keep_k & topp_kept_sorted_plain(keys, torch.softmax(f, -1), keep_k, top_p)).numpy()
    ref = np.asarray(_filtered_jax(jnp.asarray(x), jnp.full((len(KINDS), 1), k, jnp.int32),
                                   jnp.full((len(KINDS), 1), top_p, jnp.float32)))
    clear = _clear_rows(f.numpy(), top_p)
    assert clear.sum() >= 3
    np.testing.assert_array_equal(kept[clear], ref[clear])
    if k <= CAND_CAP:  # the rows whose candidates the kernel sorts
        assert (keep_k.sum(1)[[0, 3, 4]] <= CAND_CAP).all()
