"""Head dim 128 of the port's training and NAR attention
(kernels/flash_attention.py: the plain versions that CPU tensors take)
against the JAX package's attention_core_flash /
attention_core_flash_prefix, whose Pallas kernels (the JAX library's flash
attention and its backward) run in interpret mode, at B = 2, H = 2,
T = 256 and a ragged T = 200 (not a multiple of the card kernels' 64-row
tiles; the JAX kernels see it padded to 256 under a segment id of its
own), hd = 128, f32, inputs from a numpy seed. The gradients are jax.grad
of sum(out * w) against autograd through the port.

Also the layout rules the bf16 kernels hold at hd 128 as at hd 64: the
tensor-core route for bf16, `_check_tma` on the views the layers pass, and
the autograd backward's contiguous dO.

Tolerances as tests/test_torch_flash.py: outputs at 1e-5, dq / dk / dv at
1e-4 (f32 on both sides; the kernels fold blocks in another order and keep
(max, sum) where the port keeps the log-sum-exp).
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
    _check_tma, _tensor_cores, _tma_ok, flash_attention, flash_attention_bwd_plain,
    flash_attention_plain,
)
from vallex_tpu_torch.models import layers as TL

torch.set_num_threads(2)

B, H, T, HD = 2, 2, 256, 128


def _segments(layout: str, t: int) -> np.ndarray:
    pos = np.arange(t)
    if layout == "padded":  # one utterance, then padding
        return np.stack([(pos < t - 56), (pos < t - 100)]).astype(np.int32)
    # packed: two utterances back to back, then padding
    return np.stack([np.where(pos < 100, 1, np.where(pos < 180, 2, 0)),
                     np.where(pos < 60, 1, np.where(pos < 170, 2, 0))]).astype(np.int32)


def _inputs(seed: int, t: int = T):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, t, HD)).astype(np.float32) for _ in range(4)]


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _jax_grads(fn, q, k, v, w, seg):
    """out and jax.grad of sum(out * w) for q, k, v; fn(q, k, v, seg). The
    JAX kernels take T in multiples of 128 only: a ragged T runs there
    padded to the next multiple, the pad rows under a segment id no real row
    has (so no real row sees them, nor they a real row) and weight 0, and
    the real rows are returned."""
    t = q.shape[2]
    tp = -(-t // 128) * 128
    pad = [(0, 0), (0, 0), (0, tp - t), (0, 0)]
    q, k, v, w = (np.pad(a, pad) for a in (q, k, v, w))
    seg = jnp.asarray(np.pad(seg, [(0, 0), (0, tp - t)], constant_values=-1))
    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg)
    grads = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c, seg) * jnp.asarray(w)),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out)[:, :, :t], [np.asarray(g)[:, :, :t] for g in grads]


def _port_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _compare(want, got):
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for name, gp, gj in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(gp, gj, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("t", [T, 200])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_attention_core_flash_head_dim_128_grads_match_pallas_interpret(interpret, layout,
                                                                        causal, t):
    """Key padding or packed segments, causal or not: out and dq / dk / dv."""
    q, k, v, w = _inputs(11, t)
    seg = _segments(layout, t)
    tseg = torch.from_numpy(seg)
    want = _jax_grads(lambda a, b, c, js: JL.attention_core_flash(a, b, c, js, js, causal=causal),
                      q, k, v, w, seg)
    got = _port_grads(lambda a, b, c: TL.attention_core_flash(a, b, c, tseg, tseg, causal=causal),
                      q, k, v, w)
    _compare(want, got)


@pytest.mark.parametrize("t", [T, 200])
@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_attention_core_flash_prefix_head_dim_128_grads_match_pallas_interpret(interpret, layout,
                                                                               t):
    """The AR's prefix-causal mask at P = 128: out and dq / dk / dv."""
    q, k, v, w = _inputs(12, t)
    seg = _segments(layout, t)
    tseg = torch.from_numpy(seg)
    want = _jax_grads(
        lambda a, b, c, js: JL.attention_core_flash_prefix(a, b, c, js, js, 128), q, k, v, w, seg)
    got = _port_grads(
        lambda a, b, c: TL.attention_core_flash_prefix(a, b, c, tseg, tseg, 128), q, k, v, w)
    _compare(want, got)


@pytest.mark.parametrize("rows", [1, 2])
def test_nar_attention_head_dim_128_matches_pallas_interpret(interpret, rows):
    """The port's NAR attention at hd 128 (a d_model 1024 model with 8 heads
    has it; here 2 heads) against attention_core_flash with the JAX
    package's NAR segments (ok, ok), on the valid rows at 1e-5."""
    s_text, t_audio = 64, 192
    xl, tl = np.array([40, 64][:rows]), np.array([150, 101][:rows])
    q, k, v, _ = (a[:rows] for a in _inputs(13, s_text + t_audio))
    cols = np.arange(s_text + t_audio)[None, :]
    ok = np.where(cols < s_text, cols < xl[:, None], (cols - s_text) < tl[:, None])
    seg = jnp.asarray(ok.astype(np.int32))
    want = np.asarray(JL.attention_core_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              seg, seg))
    bounds = (int(xl[0]), int(tl[0])) if rows == 1 else (torch.from_numpy(xl),
                                                         torch.from_numpy(tl))
    port_ok = TNAR.key_padding(s_text, t_audio, *bounds)
    got = TNAR.flash_attention_fn(port_ok, rows)(*(torch.from_numpy(a) for a in (q, k, v)))
    valid = ok[:, None, :, None].repeat(H, 1).repeat(HD, 3)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_core_route(dtype, hd):
    """bf16 takes the tensor-core kernels at both head dims (so the wrappers
    hold it to the TMA layout rule); f32 the CUDA-core ones."""
    q = torch.zeros((1, 1, 8, hd), dtype=dtype)
    assert _tensor_cores(q) == (dtype == torch.bfloat16)


def _views(hd: int):
    """The layouts of tests/test_torch_flash.py's _TMA_VIEWS at head dim hd:
    (make, accepted)."""
    def fused(i):
        qkv = torch.zeros((B, 8, 3 * H * hd), dtype=torch.bfloat16)
        return qkv.chunk(3, dim=-1)[i].view(B, 8, H, hd).transpose(1, 2)

    bf = torch.bfloat16
    return {
        "contiguous": (lambda: torch.zeros((B, H, 8, hd), dtype=bf), True),
        "fused_q": (lambda: fused(0), True),
        "fused_v": (lambda: fused(2), True),
        "transposed_dout": (lambda: torch.zeros((B, 8, H, hd), dtype=bf).transpose(1, 2), True),
        "size1_odd_stride": (lambda: torch.zeros(H * 8 * hd, dtype=bf).as_strided(
            (1, H, 8, hd), (7, 8 * hd, hd, 1)), True),
        "base_off": (lambda: torch.zeros(B * H * 8 * hd + 1, dtype=bf)[1:].view(B, H, 8, hd),
                     False),
        "row_stride_off": (lambda: torch.zeros((B, H, 8, hd + 4), dtype=bf)[..., :hd], False),
        "head_stride_off": (lambda: torch.zeros((B, H * 8 * hd + 4), dtype=bf)[
            :, :H * 8 * hd].view(B, H, 8, hd), False),
    }


@pytest.mark.parametrize("view", list(_views(HD)))
def test_check_tma_views_head_dim_128(view):
    """_check_tma at hd 128, where bf16 now runs on the tensor cores: each
    base address and each stride of a dim longer than 1 a multiple of 16
    bytes; the views the training layers pass meet it, others raise."""
    make, ok = _views(HD)[view]
    t = make()
    assert t.stride(-1) == 1 and t.shape[-1] == HD
    assert _tma_ok(t) == ok
    if ok:
        _check_tma(t, name="test")
    else:
        with pytest.raises(ValueError, match="16-byte"):
            _check_tma(t, name="test")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_makes_misaligned_dout_contiguous_head_dim_128(monkeypatch, dtype):
    """FlashAttention.backward at hd 128 hands flash_attention_bwd a dO that
    meets the kernels' layout rule when the incoming gradient is a view off
    it; the gradients equal flash_attention_bwd_plain's on the same values."""
    fa = importlib.import_module("vallex_tpu_torch.kernels.flash_attention")
    seen = []
    orig = fa.flash_attention_bwd

    def spy(q, k, v, q_seg, kv_seg, prefix, out, lse, dout):
        seen.append(dout)
        return orig(q, k, v, q_seg, kv_seg, prefix, out, lse, dout)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    t, prefix = 150, 37
    q, k, v, w = (torch.from_numpy(a).to(dtype) for a in _inputs(14, t))
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
