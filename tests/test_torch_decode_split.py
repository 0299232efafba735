"""The decode attention's key split (kernels/masked_attention.cu: a cluster of
SPLIT_BLOCKS blocks per (row, head, query group), merged in rank order) on
the CPU, through its plain versions in kernels/masked_attention.py:

- `split_chunks_plain`, the kernel's partition rule: the chunks cover each
  row's virtual keys exactly once, in rank order, start on tile boundaries,
  and empty chunks come only at the end; the partition is equal between
  the layouts that chip_smoke.py holds bitwise (4c: grouped rows against
  their expanded rows; 5e: a batch row's range 1 + range 2 against the
  request alone in range 2);
- `masked_attention_split_plain`, the per-rank partials and their merge,
  against `masked_attention_plain` at 1e-6 (f32 on both sides, summed in
  another order) over per-row bounds, grouped rows with beams 5, int8 K/V
  with scales, the own column, Tq 1 / 8 / 16 / 40, head dim 64 / 128, a row
  with no keys and rows with fewer keys than SPLIT_BLOCKS tiles;
- the own-column mode against the JAX package's Pallas decode_attention run
  in interpret mode, at 1e-5 (as tests/test_torch_decode_attention.py).
Inputs are made with numpy from a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vallex_tpu_torch.kernels.masked_attention import (
    QUERY_GROUP, SPLIT_BLOCKS, SPLIT_TILE, attention_bounds, key_counts,
    masked_attention_plain, masked_attention_split_plain, split_chunks_plain,
    with_prefix,
)

torch.set_num_threads(1)

S_TEXT, H = 48, 2


def _t(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _rows(vals):
    return torch.tensor(vals, dtype=torch.int32)


def _layout(name):
    """(bounds, C, P, slot) of one layout at toy size: `single` (range 2
    only), `batched` (per-row range 1 + range 2), `grouped` (2 requests x 3
    samples over a prefix), `own` (Tq = 1, the walk cut at the slot)."""
    if name == "single":
        return attention_bounds(1, x_len=30, s_text=S_TEXT, audio_len=150, q_off=1), 260, None, None
    if name == "batched":
        b = attention_bounds(3, x_len=_rows([10, 48, 1]), s_text=S_TEXT,
                             audio_len=_rows([5, 60, 0]), q_off=1, gen_lo=S_TEXT + 64,
                             gen_len=_rows([100, 3, 0]))
        return b, S_TEXT + 64 + 140, None, None
    if name == "grouped":
        b = attention_bounds(6, x_len=_rows([12] * 3 + [40] * 3), s_text=S_TEXT,
                             audio_len=_rows([20] * 3 + [7] * 3), q_off=1, gen_lo=0,
                             gen_len=_rows([90, 90, 90, 33, 33, 33]))
        return b, 120, S_TEXT + 64, None
    b = attention_bounds(2, x_len=_rows([17, 48]), s_text=S_TEXT, audio_len=200, q_off=0)
    return b, 300, None, S_TEXT + 200


# the own-column mode takes one query
LAYOUTS = [(n, Tq) for n in ("single", "batched", "grouped", "own") for Tq in (1, 8, 16, 40)
           if n != "own" or Tq == 1]


@pytest.mark.parametrize("name,Tq", LAYOUTS)
def test_chunks_cover_each_rows_keys_once_in_rank_order(name, Tq):
    bounds, C, P, slot = _layout(name)
    counts = key_counts(bounds, Tq, C, P=P, slot=slot)
    ch = split_chunks_plain(bounds, Tq, C, P=P, slot=slot)
    G = -(-Tq // QUERY_GROUP)
    assert ch.shape == (bounds.lens.shape[1], G, SPLIT_BLOCKS, 2)
    for b in range(ch.shape[0]):
        for g in range(G):
            n = int(counts[b, min(Tq, (g + 1) * QUERY_GROUP) - 1])
            starts, ends = ch[b, g, :, 0].tolist(), ch[b, g, :, 1].tolist()
            assert starts[0] == 0 and ends[-1] == n
            assert all(e0 == s1 for e0, s1 in zip(ends, starts[1:]))  # in rank order
            assert all(s <= e for s, e in zip(starts, ends))
            assert all(s % SPLIT_TILE == 0 for s, e in zip(starts, ends) if e > s)
            sizes = [e - s for s, e in zip(starts, ends)]
            first_empty = next((r for r, z in enumerate(sizes) if z == 0), SPLIT_BLOCKS)
            assert all(z == 0 for z in sizes[first_empty:])  # empty chunks only at the end
            covered = torch.zeros(n, dtype=torch.int64)
            for s, e in zip(starts, ends):
                covered[s:e] += 1
            assert bool((covered == 1).all())


@pytest.mark.parametrize("Tq", [1, 8])
@pytest.mark.parametrize("pair", ["4c", "5e"])
def test_partition_equal_between_bitwise_layouts(pair, Tq):
    if pair == "4c":
        # grouped rows (text + prompt from the request's prefix) against the
        # same rows with the prefix copied in front of each row's own cache
        beams, P, C = 5, S_TEXT + 96, 400
        rep = lambda v: _rows(v).repeat_interleave(beams)  # noqa: E731
        grouped = attention_bounds(2 * beams, x_len=rep([20, 48]), s_text=S_TEXT,
                                   audio_len=rep([61, 9]), q_off=1, gen_lo=0,
                                   gen_len=rep([350, 90]))
        k = torch.zeros((2 * beams, 1, C, 64))
        prefix = (torch.zeros((2, 1, P, 64)),) * 2
        _, _, expanded = with_prefix(k, k, grouped, prefix, beams)
        a = split_chunks_plain(grouped, Tq, C, P=P)
        b = split_chunks_plain(expanded, Tq, C + P)
        assert torch.equal(key_counts(grouped, Tq, C, P=P), key_counts(expanded, Tq, C + P))
    else:
        # each batch row (BOS + prompt in range 1, generated rows in range 2)
        # against its request alone (every audio row in range 2)
        xl, pl, gen, PA, T = [20, 41, 48], [0, 60, 400], [600, 350, 7], 512, 800
        batched = attention_bounds(3, x_len=_rows(xl), s_text=S_TEXT,
                                   audio_len=_rows(pl) + 1, q_off=1, gen_lo=S_TEXT + PA,
                                   gen_len=_rows(gen) + 1)
        a = split_chunks_plain(batched, Tq, S_TEXT + PA + T)
        b = torch.cat([split_chunks_plain(
            attention_bounds(1, x_len=xl[i], s_text=S_TEXT, audio_len=pl[i] + 1 + gen[i] + 1,
                             q_off=1), Tq, S_TEXT + PA + T) for i in range(3)])
    assert torch.equal(a, b)


MODES = ["rows", "grouped", "int8", "empty", "few", "own", "own_f32", "own_int8"]
CASES = [(m, Tq, hd) for m in MODES for Tq in (1, 8, 16, 40) for hd in (64, 128)
         if not m.startswith("own") or Tq == 1]


def _case(mode, Tq, hd, seed):
    """(q, k, v, bounds, keywords) of one mode at toy size, made by numpy."""
    rng = np.random.RandomState(seed)
    kw = {}
    if mode in ("rows", "int8", "empty", "few"):
        B, C = 3, S_TEXT + 64 + 260
        x, a1, gen = {"rows": ([10, 48, 0], [5, 60, 0], [200, 3, 0]),
                      "int8": ([30, 1, 48], [64, 0, 9], [120, 260, 0]),
                      "empty": ([0, 0, 0], [0, 0, 0], [0, 0, 0]),
                      "few": ([40, 1, 0], [0, 7, 0], [0, 31, 1])}[mode]
        bounds = attention_bounds(B, x_len=_rows(x), s_text=S_TEXT, audio_len=_rows(a1),
                                  q_off=0 if mode == "empty" else 1, gen_lo=S_TEXT + 64,
                                  gen_len=_rows(gen))
    elif mode == "grouped":
        beams, R, C, P = 5, 2, 300, S_TEXT + 64
        B = R * beams
        rep = lambda v: _rows(v).repeat_interleave(beams)  # noqa: E731
        bounds = attention_bounds(B, x_len=rep([20, 48]), s_text=S_TEXT, audio_len=rep([61, 9]),
                                  q_off=1, gen_lo=0, gen_len=rep([150, 40]))
        kw.update(prefix=(_t(rng, R, H, P, hd), _t(rng, R, H, P, hd)), beams=beams)
    else:
        B, C = 2, S_TEXT + 260
        slot = S_TEXT + 230
        bounds = attention_bounds(B, x_len=_rows([17, 48]), s_text=S_TEXT, audio_len=230,
                                  q_off=0)
        kw.update(new_kv=(_t(rng, B, H, 1, hd), _t(rng, B, H, 1, hd)), slot=slot)
    q = _t(rng, B, H, Tq, hd)
    k, v = _t(rng, B, H, C, hd), _t(rng, B, H, C, hd)
    if mode in ("int8", "own_int8"):
        # quantized as the engine's int8 cache: a scale per head, max |x| / 127
        scales = tuple(t.abs().amax(dim=(0, 2, 3)) / 127.0 for t in (k, v))
        k, v = (torch.round(t / s[None, :, None, None]).to(torch.int8)
                for t, s in zip((k, v), scales))
        kw["kv_scales"] = scales
    elif mode == "own":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return q, k, v, bounds, kw


@pytest.mark.parametrize("mode,Tq,hd", CASES)
def test_split_plain_matches_plain(mode, Tq, hd):
    q, k, v, bounds, kw = _case(mode, Tq, hd, seed=Tq * 7 + hd)
    got = masked_attention_split_plain(q, k, v, bounds, **kw)
    want = masked_attention_plain(q, k, v, bounds, **kw)
    assert got.shape == want.shape == q.shape
    assert bool(torch.isfinite(got).all())
    # a query with no key: the kernel's output is 0 (the plain version's
    # softmax over nothing is NaN); every other output at 1e-6
    none = key_counts(bounds, Tq, k.shape[2], P=None if "prefix" not in kw
                      else kw["prefix"][0].shape[2], slot=kw.get("slot")) == 0
    if "new_kv" in kw:
        none[:] = False  # the own column is always there
    none = none[:, None, :, None].expand_as(got)
    assert not bool(got[none].any())
    assert int(none.sum()) == (got.numel() if mode == "empty" else int(torch.isnan(want).sum()))
    np.testing.assert_allclose(got[~none].numpy(), want[~none].numpy(), atol=1e-6, rtol=1e-6)
    if mode == "few":  # fewer tiles than blocks: trailing ranks walk nothing
        ch = split_chunks_plain(bounds, Tq, k.shape[2])
        assert bool((ch[:, :, -1, 0] == ch[:, :, -1, 1]).all())


@pytest.mark.parametrize("B,x_len,audio_pos", [(1, 100, 0), (2, 128, 200), (2, 37, 383)])
def test_split_plain_own_column_matches_jax_kernel(monkeypatch, B, x_len, audio_pos):
    """The own-column mode (decode_attention's) of the split plain version
    against the JAX package's Pallas decode_attention in interpret mode."""
    HD, C, s_text, Hj = 64, 512, 128, 4
    rng = np.random.RandomState(B * 100 + audio_pos)
    q, nk, nv = (rng.randn(B, Hj, HD).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(B, Hj, C, HD).astype(np.float32) for _ in range(2))

    import jax.experimental.pallas as pl_mod

    orig = pl_mod.pallas_call
    monkeypatch.setattr(pl_mod, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    from vallex_tpu.ops import decode_attention as DA

    DA = importlib.reload(DA)
    want, _, _ = DA.decode_attention(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), DA.pack_cache(jnp.asarray(ck)),
        DA.pack_cache(jnp.asarray(cv)), jnp.asarray(x_len, jnp.int32),
        jnp.asarray(audio_pos, jnp.int32), s_text=s_text)
    monkeypatch.undo()

    bounds = attention_bounds(B, x_len=x_len, s_text=s_text, audio_len=audio_pos, q_off=0)
    got = masked_attention_split_plain(
        torch.from_numpy(q)[:, :, None], torch.from_numpy(ck), torch.from_numpy(cv), bounds,
        new_kv=(torch.from_numpy(nk)[:, :, None], torch.from_numpy(nv)[:, :, None]),
        slot=s_text + audio_pos)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
