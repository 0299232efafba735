"""The layout and prologue rules of the port's f32 kernels, on the CPU.

- The f32 flash forward (kernels/flash_attention_f32.cu, flash_fwd_ffma_kernel)
  reads q, k and v in 16-byte cp.async pieces, so `flash_attention.py`
  holds f32 q/k/v to the 16-byte rule on base and strides, as it holds bf16
  (`_check_tma`, which `flash_attention_fwd` applies to q, k, v of either
  dtype): the training layers' fused-QKV views and a
  transposed dO pass, a view off by one float or with a row stride of
  hd + 1 raises with the rule in its message.
- The f32 backward kernels (kernels/flash_attention_f32_bwd.cu) read q, k,
  v, O and dO the same way, so `flash_attention_bwd_dq` / `_dkv` hold them
  to the rule before any launch: with the library replaced by a recorder,
  an accepted view launches kind 0 once per wrapper, another raises naming
  the rule and records no launch.
- The f32 product of `gemm_small_m` reads its LayerNorm rows from the prep
  kernel's f32 scratch: `gemm_prep_plain(dtype=float32)` (the prep kernel's
  plain version) against the JAX package's LayerNorm of
  vallex_tpu/ops/decode_block.py (`ln`: jnp.mean, jnp.var, rsqrt, eps
  1e-5) on the same rows, rtol 1e-6 (f32 on both sides, sums in another
  order).
- The scratch the wrapper allocates for each kind (`prep_scratch_bytes`).
"""

import collections
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu_torch.kernels import loader
from vallex_tpu_torch.kernels.flash_attention import _check_tma, _tma_ok
from vallex_tpu_torch.kernels.gemm_small_m import gemm_prep_plain, prep_scratch_bytes

B, H, T = 2, 2, 8


def _views(hd: int):
    """f32 layouts at head dim hd: (make, accepted)."""
    def fused(i):
        qkv = torch.zeros((B, T, 3 * H * hd))
        return qkv.chunk(3, dim=-1)[i].view(B, T, H, hd).transpose(1, 2)

    return {
        "contiguous": (lambda: torch.zeros((B, H, T, hd)), True),
        "fused_q": (lambda: fused(0), True),
        "fused_k": (lambda: fused(1), True),
        "fused_v": (lambda: fused(2), True),
        "transposed_dout": (lambda: torch.zeros((B, T, H, hd)).transpose(1, 2), True),
        "base_off_one_float": (lambda: torch.zeros(B * H * T * hd + 1)[1:].view(B, H, T, hd),
                               False),
        "row_stride_hd_plus_1": (lambda: torch.zeros((B, H, T, hd + 1))[..., :hd], False),
    }


@pytest.mark.parametrize("view", list(_views(64)))
@pytest.mark.parametrize("hd", [64, 128])
def test_f32_forward_16_byte_rule(hd, view):
    """f32 q/k/v: the views the layers pass meet the rule; the others raise,
    naming it (the wrapper never copies quietly)."""
    make, ok = _views(hd)[view]
    t = make()
    assert t.dtype == torch.float32 and t.stride(-1) == 1 and t.shape[-1] == hd
    assert _tma_ok(t) == ok
    if ok:
        _check_tma(t, t, t)
    else:
        with pytest.raises(ValueError, match="float32 tensors need 16-byte"):
            _check_tma(t, t, t)
        good = torch.zeros((B, H, T, hd))
        with pytest.raises(ValueError, match="16-byte"):
            _check_tma(good, t, t)


class _Recorder:
    """Stands in for the kernel library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("view", list(_views(64)))
@pytest.mark.parametrize("hd", [64, 128])
def test_f32_backward_16_byte_rule(monkeypatch, hd, view):
    """f32 q, k, v, O and dO in one layout through both backward wrappers:
    the accepted views launch the f32 kernels (kind 0) once each, the others
    raise naming the rule before any launch."""
    fa = importlib.import_module("vallex_tpu_torch.kernels.flash_attention")
    rec = _Recorder()
    monkeypatch.setattr(fa, "library", lambda: rec)
    monkeypatch.setattr(fa, "stream_ptr", lambda t: 0)
    counts, seconds = collections.Counter(), collections.Counter()
    monkeypatch.setattr(loader, "launch_counts", counts)  # where count_launch counts
    monkeypatch.setattr(loader, "launch_seconds", seconds)
    make, ok = _views(hd)[view]
    q, k, v, out, dout = (make() for _ in range(5))
    seg = torch.ones((B, T), dtype=torch.int32)
    lse = torch.zeros((B, H, T))
    if ok:
        dq, di = fa.flash_attention_bwd_dq(q, k, v, seg, seg, T, out, lse, dout)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, seg, T, dout, lse, di)
        assert [name for name, _ in rec.calls] == ["vx_flash_attention_bwd_dq",
                                                   "vx_flash_attention_bwd_dkv"]
        assert rec.calls[0][1][14] == 0 and rec.calls[1][1][13] == 0  # kind: f32
        assert rec.calls[0][1][15] == hd and rec.calls[1][1][14] == hd
        assert sorted(counts.values()) == [1, 1] and set(seconds) == set(counts)
        for t in (dq, dk, dv):
            assert t.shape == (B, H, T, hd) and t.dtype == torch.float32
    else:
        with pytest.raises(ValueError, match="float32 tensors need 16-byte"):
            fa.flash_attention_bwd_dq(q, k, v, seg, seg, T, out, lse, dout)
        with pytest.raises(ValueError, match="float32 tensors need 16-byte"):
            fa.flash_attention_bwd_dkv(q, k, v, seg, seg, T, dout, lse, lse.clone())
        assert rec.calls == [] and not counts and not seconds


def _jax_ln(x, s, b, eps=1e-5):
    """vallex_tpu/ops/decode_block.py:155-158."""
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.var(x, axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + eps) * s + b


@pytest.mark.parametrize("K", [1024, 4096])
def test_gemm_prep_plain_f32_rows_match_jax_layernorm(K):
    """The f32 prep rows (the f32 product's LayerNorm prologue) against the
    JAX kernels' LayerNorm on the same rows."""
    rng = np.random.RandomState(K)
    x = (rng.standard_normal((5, K)) * 2.0 + 0.5).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(K)).astype(np.float32)
    want = np.asarray(_jax_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = gemm_prep_plain(torch.from_numpy(x), ln=(torch.from_numpy(s), torch.from_numpy(b)),
                          dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (5, K)
    # the elements near 0 (|y| < 1e-3 of the row's scale) lose relative
    # precision to the cancellation of (x - m) * r * s against b on both sides
    scale = np.abs(want).max(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * float(scale.max()))


@pytest.mark.parametrize("M", [1, 8, 20])
def test_gemm_prep_plain_f32_cast_is_the_rows(M):
    """Without a LayerNorm the f32 prep rows are x itself, bitwise."""
    x = torch.from_numpy(np.random.RandomState(M).standard_normal((M, 1024)).astype(np.float32))
    assert torch.equal(gemm_prep_plain(x, dtype=torch.float32), x)


@pytest.mark.parametrize("case, want", [
    # f32 weights: the prep kernel's f32 rows for a LayerNorm, or for rows
    # the product cannot read in 16-byte pieces; none for an aligned cast
    (dict(w_dtype=torch.float32, layer_norm=True), 4 * 8 * 1024),
    (dict(w_dtype=torch.float32), 0),
    (dict(w_dtype=torch.float32, x_aligned=False), 4 * 8 * 1024),
    # bf16 and int8 (W8A16) weights: bf16 rows
    (dict(w_dtype=torch.bfloat16, layer_norm=True), 2 * 8 * 1024),
    (dict(w_dtype=torch.bfloat16), 0),
    (dict(w_dtype=torch.bfloat16, x_aligned=False), 2 * 8 * 1024),
    (dict(w_dtype=torch.int8, layer_norm=True), 2 * 8 * 1024),
    (dict(w_dtype=torch.int8), 0),
    # W8A8: the int8 codes, then 8 f32 scales at the next 16-byte boundary,
    # with or without a LayerNorm
    (dict(w_dtype=torch.int8, act_quant=True), 8 * 1024 + 4 * 8),
    (dict(w_dtype=torch.int8, act_quant=True, layer_norm=True), 8 * 1024 + 4 * 8),
])
def test_prep_scratch_bytes(case, want):
    """The scratch `gemm_small_m` allocates per kind, at M = 8, K = 1024."""
    case = dict(case)
    w_dtype = case.pop("w_dtype")
    assert prep_scratch_bytes(8, 1024, w_dtype, **case) == want


def test_prep_scratch_bytes_w8a8_scales_start_16_byte_aligned():
    """W8A8 at M * K not a multiple of 16: the scales start at the next
    16-byte boundary after the codes."""
    assert prep_scratch_bytes(3, 1028, torch.int8, act_quant=True) == 3084 + 4 + 4 * 3
