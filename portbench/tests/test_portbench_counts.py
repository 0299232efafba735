"""The operation and byte counters against counts made by hand."""

import pytest

from portbench.roofline import counts as R

M = dict(d_model=4, ffn_dim=8, num_layers=2, num_audio_tokens=3, num_quantizers=3)
V = dict(input_channels=2, dim=4, intermediate_dim=6, num_layers=1, kernel=3, n_fft=6)
BW, PEAK = R.PEAKS["hbm_bytes_per_s"], R.PEAKS["bf16_flops_per_s"]


def test_dense_per_token():
    # a layer: 4·12 + 4·4 + 4·8 + 8·4 = 128 weights, 2 FLOPs each, 2 layers
    assert R.dense_flops_per_token(4, 8, 2) == 2 * 2 * 128


def test_prefill_by_hand():
    # x_len 2, prompt 1: positions 2 + 1 + 1 = 4; pairs: text rows 2 · (2 + 1),
    # audio rows j = 0, 1 see 2 + j + 1 keys: 3 + 4
    pairs = 6 + 7
    want = 512 * 4 + 4 * 4 * pairs * 2 + 2 * 4 * 4
    assert R.ar_prefill_flops(M, 2, 1) == want


def test_decode_by_hand():
    # 2 generated frames: keys at t = 0, 1: 2 + 1 + 1 + 1, + 1
    assert R.decode_keys(2, 1, 0) == 5 and R.decode_keys(2, 1, 1) == 6
    want = (512 + 2 * 4 * 4) * 2 + 4 * 4 * (5 + 6) * 2
    assert R.ar_decode_flops(M, 2, 1, 2) == want
    assert R.ar_decode_flops(M, 2, 1, 0) == 0


def test_nar_by_hand():
    n = 2 + 1 + 2
    stage = 512 * n + 4 * 4 * n * n * 2 + 2 * 4 * 3 * 2
    assert R.nar_flops(M, 2, 1, 2) == 2 * stage


def test_vocos_by_hand():
    per = 2 * 3 * 2 * 4 + 1 * (2 * 3 * 4 + 4 * 4 * 6) + 2 * 4 * 8
    assert R.vocos_flops(V, 5) == 5 * per


def test_live_rows():
    assert R.live_rows([3, 1, 0], 4) == [2, 1, 1, 0]


def test_gemm_bound_by_hand():
    # one live row for one step, int8 weights: each product's weights, its
    # scales and the row's f32 input and output; all bandwidth-bound here
    shapes = [(4, 12), (4, 4), (4, 8), (8, 4)] * 2 + [(4, 4)]
    nbytes = sum(k * n + 4 * n + 4 * (k + n) for k, n in shapes)
    got = R.gemm_small_m_bound_s(M, 1, [1, 0], 1)
    assert got == pytest.approx(nbytes / BW)
    # the same step in bf16: two bytes a weight, no scales
    nbytes = sum(2 * k * n + 4 * (k + n) for k, n in shapes)
    assert R.gemm_small_m_bound_s(M, 2, [1], 1) == pytest.approx(nbytes / BW)


def test_attention_bound_by_hand():
    # rows (x 2, p 1, g 2) and (x 3, p 0, g 1), two steps, int8 K/V
    reqs = [(2, 1, 2), (3, 0, 1)]
    t0 = (2 * 5 * 4 + 32) + (2 * 5 * 4 + 32)  # both live, 5 keys each
    t1 = 2 * 6 * 4 + 32
    assert R.masked_attention_bound_s(M, 1, reqs, 2) == pytest.approx(2 * (t0 + t1) / BW)


def test_bound_takes_the_larger():
    assert R._bound_s(PEAK, 1.0) == pytest.approx(1.0)
    assert R._bound_s(1.0, BW) == pytest.approx(1.0)
