"""The port's training attention (kernels/flash_attention.py, the plain
versions that CPU tensors take) against the JAX package's
attention_core_flash / attention_core_flash_prefix, whose Pallas kernels
(the JAX library's flash attention and its backward) run in interpret mode,
at B = 2, H = 2, T = 256, hd = 64 (and hd = 128 for the prefix-causal
call) in f32.

The NAR's attention (engine/nar.py at C >= 1536) is held the same way
against attention_core_flash with the JAX package's NAR segments.

Tolerances: outputs at 1e-5 and dq / dk / dv at 1e-4 (f32 on both sides;
the kernels fold blocks in another order and keep (max, sum) where the port
keeps the log-sum-exp); the port's own backward formula against autograd
at 1e-5; the single-mask rule against the two-call composition at 1e-6.
"""

import importlib

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu.models import layers as JL
from vallex_tpu_torch.engine import nar as TNAR
from vallex_tpu_torch.kernels.flash_attention import (
    _check_tma, _tma_ok, flash_attention, flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain, flash_attention_bwd_plain, flash_attention_plain, valid_pairs,
)
from vallex_tpu_torch.models import layers as TL

torch.set_num_threads(2)

B, H, T, HD = 2, 2, 256, 64


def _segments(layout: str, t: int = T) -> np.ndarray:
    pos = np.arange(t)
    if layout == "padded":  # one utterance, then padding
        row = (pos < t - 56).astype(np.int32)
        return np.stack([row, (pos < t - 100).astype(np.int32)])
    if layout == "packed":  # two utterances back to back, then padding
        row = np.where(pos < 100, 1, np.where(pos < 220, 2, 0)).astype(np.int32)
        return np.stack([row, np.where(pos < 60, 1, np.where(pos < 190, 2, 0)).astype(np.int32)])
    return np.ones((2, t), np.int32)  # all valid


def _inputs(seed: int, t: int = T, hd: int = HD):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.standard_normal((B, H, t, hd)).astype(np.float32) for _ in range(4))
    return q, k, v, w


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _jax_out_and_grads(fn, q, k, v, w):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _port_out_and_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _compare(jax_res, port_res):
    np.testing.assert_allclose(port_res[0], jax_res[0], atol=1e-5, rtol=1e-5)
    for name, gp, gj in zip("qkv", port_res[1], jax_res[1]):
        np.testing.assert_allclose(gp, gj, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["padded", "packed", "all_valid"])
def test_attention_core_flash_matches_pallas_interpret(interpret, layout, causal):
    q, k, v, w = _inputs(1)
    seg = _segments(layout)
    jseg = jnp.asarray(seg)
    tseg = torch.from_numpy(seg)
    want = _jax_out_and_grads(
        lambda a, b, c: JL.attention_core_flash(a, b, c, jseg, jseg, causal=causal), q, k, v, w)
    got = _port_out_and_grads(
        lambda a, b, c: TL.attention_core_flash(a, b, c, tseg, tseg, causal=causal), q, k, v, w)
    _compare(want, got)


@pytest.mark.parametrize("layout", ["padded", "packed", "all_valid"])
def test_attention_core_flash_prefix_matches_pallas_interpret(interpret, layout):
    q, k, v, w = _inputs(2)
    seg = _segments(layout)
    jseg = jnp.asarray(seg)
    tseg = torch.from_numpy(seg)
    want = _jax_out_and_grads(
        lambda a, b, c: JL.attention_core_flash_prefix(a, b, c, jseg, jseg, 128), q, k, v, w)
    got = _port_out_and_grads(
        lambda a, b, c: TL.attention_core_flash_prefix(a, b, c, tseg, tseg, 128), q, k, v, w)
    _compare(want, got)


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_attention_core_flash_prefix_head_dim_128_matches_pallas_interpret(interpret, layout):
    """Head dim 128 (a d_model 256 model with 2 heads; the card's kernels
    are built for 64 and 128): the AR's prefix-causal attention and its
    gradients, at the tolerances above."""
    q, k, v, w = _inputs(3, hd=128)
    seg = _segments(layout)
    jseg = jnp.asarray(seg)
    tseg = torch.from_numpy(seg)
    want = _jax_out_and_grads(
        lambda a, b, c: JL.attention_core_flash_prefix(a, b, c, jseg, jseg, 128), q, k, v, w)
    got = _port_out_and_grads(
        lambda a, b, c: TL.attention_core_flash_prefix(a, b, c, tseg, tseg, 128), q, k, v, w)
    _compare(want, got)


@pytest.mark.parametrize("prefix", [0, 37, 150])
def test_backward_formula_matches_autograd(prefix):
    """flash_attention_bwd_plain (the formula the kernels run) against
    autograd through flash_attention_plain, at T = 150 (not a multiple of
    the kernels' 64-row tiles)."""
    t = 150
    q, k, v, w = _inputs(3, t)
    seg = torch.from_numpy(_segments("packed", t))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = flash_attention_plain(qt, kt, vt, seg, seg, prefix)
    want = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    got = flash_attention_bwd_plain(qt.detach(), kt.detach(), vt.detach(), seg, seg, prefix,
                                    out.detach(), lse.detach(), torch.from_numpy(w))
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")
    # the two kernels' halves (dQ with di; dK/dV) give the same gradients
    args = (qt.detach(), kt.detach(), vt.detach(), seg, seg, prefix, out.detach(),
            lse.detach(), torch.from_numpy(w))
    dq, di = flash_attention_bwd_dq_plain(*args)
    dk, dv = flash_attention_bwd_dkv_plain(*args)
    for g, r in zip((dq, dk, dv), got):
        assert torch.equal(g, r)
    np.testing.assert_allclose(di.numpy(), (out * torch.from_numpy(w)).sum(-1).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    # and the autograd.Function routes its backward through that formula
    fn_grads = torch.autograd.grad(
        (flash_attention(qt, kt, vt, seg, seg, prefix) * torch.from_numpy(w)).sum(),
        (qt, kt, vt))
    for g, r in zip(fn_grads, got):
        assert torch.equal(g, r)


@pytest.mark.parametrize("layout", ["padded", "packed", "all_valid"])
def test_single_mask_equals_two_call_composition(layout):
    """The kernel's rule j <= max(i, P - 1) with P = text_len equals
    vallex_tpu/models/layers.py:278-289: a causal pass over the whole
    sequence whose text rows are replaced by a non-causal pass over the
    text block alone — on every row, in f32."""
    P = 128
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(4))
    seg = torch.from_numpy(_segments(layout))
    one, _ = flash_attention_plain(q, k, v, seg, seg, P)
    causal, _ = flash_attention_plain(q, k, v, seg, seg, 0)
    text, _ = flash_attention_plain(q[:, :, :P], k[:, :, :P], v[:, :, :P], seg[:, :P],
                                    seg[:, :P], P)
    two = torch.cat([text, causal[:, :, P:]], dim=2)
    np.testing.assert_allclose(one.numpy(), two.numpy(), atol=1e-6, rtol=1e-6)
    # the diagonal is always valid under (seg, seg): no row is left empty
    assert valid_pairs(seg, seg, P).any(-1).all()


@pytest.mark.parametrize("rows", [1, 2])
def test_nar_attention_matches_pallas_interpret(interpret, rows):
    """The port's NAR attention (engine/nar.py: the flash forward with the
    key-padding rule as segments (ok, ok), prefix C) against
    attention_core_flash(q, k, v, seg, seg) with the segments the JAX
    package's NAR builds (vallex_tpu/engine/nar.py:97-102), at a NAR layout
    of T = 256: text padding in the middle (x_len < s_text) and audio
    padding at the end (t_len < t_audio). One request (int bounds) or two
    (per-row bounds); outputs on the valid rows at 1e-5, as _compare."""
    s_text, t_audio = 64, 192
    xl, tl = np.array([40, 64][:rows]), np.array([150, 101][:rows])
    q, k, v, _ = (a[:rows] for a in _inputs(5, s_text + t_audio))
    cols = np.arange(s_text + t_audio)[None, :]
    ok = np.where(cols < s_text, cols < xl[:, None], (cols - s_text) < tl[:, None])
    seg = jnp.asarray(ok.astype(np.int32))
    want = np.asarray(JL.attention_core_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              seg, seg))
    bounds = (int(xl[0]), int(tl[0])) if rows == 1 else (torch.from_numpy(xl),
                                                         torch.from_numpy(tl))
    port_ok = TNAR.key_padding(s_text, t_audio, *bounds)
    assert np.array_equal(port_ok.expand(rows, -1).numpy(), ok)
    got = TNAR.flash_attention_fn(port_ok, rows)(*(torch.from_numpy(a) for a in (q, k, v)))
    valid = ok[:, None, :, None].repeat(H, 1).repeat(HD, 3)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=1e-5, rtol=1e-5)


def _fused_qkv(dtype=torch.bfloat16):
    """q, k, v as the training layers pass them: [B, H, T, 64] views of one
    [B, T, 3 H 64] product (split_heads of its three chunks)."""
    qkv = torch.zeros((B, 8, 3 * H * HD), dtype=dtype)
    return [t.view(B, 8, H, HD).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


_TMA_VIEWS = {
    # accepted: contiguous, the fused-QKV views, a transposed dO, a dim of
    # size 1 whose stride is immaterial
    "contiguous": (lambda: torch.zeros((B, H, 8, HD), dtype=torch.bfloat16), True),
    "fused_q": (lambda: _fused_qkv()[0], True),
    "fused_v": (lambda: _fused_qkv()[2], True),
    "transposed_dout": (lambda: torch.zeros((B, 8, H, HD), dtype=torch.bfloat16).transpose(1, 2),
                        True),
    "size1_odd_stride": (lambda: torch.zeros(H * 8 * HD, dtype=torch.bfloat16).as_strided(
        (1, H, 8, HD), (7, 8 * HD, HD, 1)), True),
    # refused: a base off 16 bytes, a row stride of 68 bf16 (136 bytes), a
    # head stride off 16 bytes, and f32 rows of 65 values at an odd base
    "base_off": (lambda: torch.zeros(B * H * 8 * HD + 1, dtype=torch.bfloat16)[1:].view(
        B, H, 8, HD), False),
    "row_stride_off": (lambda: torch.zeros((B, H, 8, 68), dtype=torch.bfloat16)[..., :HD], False),
    "head_stride_off": (lambda: torch.zeros((B, H * 8 * HD + 4), dtype=torch.bfloat16)[
        :, :H * 8 * HD].view(B, H, 8, HD), False),
    "f32_odd": (lambda: torch.zeros((B, H, 8, HD + 1))[..., 1:], False),
}


@pytest.mark.parametrize("view", list(_TMA_VIEWS))
def test_check_tma_views(view):
    """_check_tma, the bf16 kernels' layout rule (kernels/flash_attention.py):
    each base address and each stride of a dim longer than 1 a multiple of
    16 bytes. The views the training layers pass meet it; others raise."""
    make, ok = _TMA_VIEWS[view]
    t = make()
    assert t.stride(-1) == 1
    assert _tma_ok(t) == ok
    if ok:
        _check_tma(t, name="test")
    else:
        with pytest.raises(ValueError, match="16-byte"):
            _check_tma(t, name="test")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_makes_misaligned_dout_contiguous(monkeypatch, dtype):
    """FlashAttention.backward hands flash_attention_bwd a dO that meets the
    kernels' layout rule when the incoming gradient is a view off it (base
    and row stride off 16 bytes); the gradients equal
    flash_attention_bwd_plain's on the same values."""
    fa = importlib.import_module("vallex_tpu_torch.kernels.flash_attention")
    seen = []
    orig = fa.flash_attention_bwd

    def spy(q, k, v, q_seg, kv_seg, prefix, out, lse, dout):
        seen.append(dout)
        return orig(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    t, prefix = 150, 37
    q, k, v, w = (torch.from_numpy(a).to(dtype) for a in _inputs(6, t))
    seg = torch.from_numpy(_segments("packed", t))
    wide = torch.zeros((B, H, t, HD + 1), dtype=dtype)
    wide[..., 1:] = w
    dout = wide[..., 1:]
    assert not _tma_ok(dout)
    qt, kt, vt = (a.clone().requires_grad_(True) for a in (q, k, v))
    got = torch.autograd.grad(flash_attention(qt, kt, vt, seg, seg, prefix), (qt, kt, vt),
                              grad_outputs=dout)
    assert len(seen) == 1 and _tma_ok(seen[0]) and seen[0].stride(-1) == 1
    assert torch.equal(seen[0], dout)
    out, lse = flash_attention_plain(q, k, v, seg, seg, prefix)
    want = flash_attention_bwd_plain(q, k, v, seg, seg, prefix, out, lse, w)
    for name, g, r in zip("qkv", got, want):
        assert torch.equal(g, r), f"d{name}"
