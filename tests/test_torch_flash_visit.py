"""The tile-visit rule of the flash kernels (`ff_visit` in
kernels/flash_attention_f32.cuh, fa_visit's rule in flash_attention.cu),
in its plain version `visit_tiles_plain`, held against the mask itself
(`valid_pairs`) on the CPU: a skipped tile holds no valid pair, a FULL tile
holds only valid pairs (inside T), and every valid pair lies in a visited
tile. Both sides: a block that owns queries lists key tiles (the forward,
the dQ kernel), one that owns keys lists query tiles (the dK/dV kernel);
own tiles of 64 and 128 rows; padded and packed rows, T = 256 and a ragged
T = 200; prefix T (key padding), 0 (causal) and 37 (prefix-causal).
"""

import numpy as np
import pytest
import torch

from vallex_tpu_torch.kernels.flash_attention import valid_pairs, visit_tiles_plain


def _segments(layout: str, t: int) -> torch.Tensor:
    """[3, t] int32 ids: "padded" one utterance a row then padding (id 0),
    "packed" utterances back to back then padding."""
    pos = np.arange(t)
    if layout == "padded":
        rows = [pos < t - 56, pos < t - 100, pos < t]
        return torch.from_numpy(np.stack(rows).astype(np.int32))
    cuts = [(70, 150, 190), (33, 64, 180), (100, 130, 140)]
    rows = [np.searchsorted(np.array(c), pos, side="right") + 1 for c in cuts]
    rows = [np.where(pos < c[-1], r, 0) for r, c in zip(rows, cuts)]
    return torch.from_numpy(np.stack(rows).astype(np.int32))


def _pairs_per_tile(ok: torch.Tensor, own_rows: int, own_is_query: bool):
    """(valid pairs, pairs inside T) of each (own tile, other tile) [B, n_own, n_other]."""
    B, T, _ = ok.shape
    if not own_is_query:
        ok = ok.transpose(1, 2)  # [B, key, query]
    n_own, n_oth = -(-T // own_rows), -(-T // 64)
    grid = torch.zeros((B, n_own * own_rows, n_oth * 64), dtype=torch.int64)
    grid[:, :T, :T] = ok.long()
    inside = torch.zeros_like(grid)
    inside[:, :T, :T] = 1

    def fold(x):
        return x.view(B, n_own, own_rows, n_oth, 64).sum((2, 4))

    return fold(grid), fold(inside)


@pytest.mark.parametrize("own_is_query", [True, False], ids=["dq_lists_keys", "dkv_lists_queries"])
@pytest.mark.parametrize("own_rows", [64, 128])
@pytest.mark.parametrize("prefix", ["T", 0, 37])
@pytest.mark.parametrize("T", [256, 200])
@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_visit_rule_against_valid_pairs(layout, T, prefix, own_rows, own_is_query):
    seg = _segments(layout, T)
    P = T if prefix == "T" else prefix
    cls = visit_tiles_plain(seg, seg, P, own_rows, own_is_query)
    valid, inside = _pairs_per_tile(valid_pairs(seg, seg, P), own_rows, own_is_query)
    assert cls.shape == valid.shape and cls.dtype == torch.int8
    assert set(cls.unique().tolist()) <= {-1, 0, 1}
    skipped, full = cls == -1, cls == 0
    assert int(valid[skipped].sum()) == 0, "a skipped tile holds a valid pair"
    assert bool((valid[full] == own_rows * 64).all()), "a FULL tile holds a masked pair"
    assert bool((inside[full] == own_rows * 64).all())
    assert int(valid[~skipped].sum()) == int(valid_pairs(seg, seg, P).sum())


def test_visit_rule_skips_and_finds_full_tiles():
    """The rule does work: at T = 256 the packed causal rows skip tiles on
    both sides, and the padded key-padding rows have FULL tiles on both."""
    T = 256
    packed, padded = _segments("packed", T), _segments("padded", T)
    for own_is_query in (True, False):
        for own_rows in (64, 128):
            assert bool((visit_tiles_plain(packed, packed, 0, own_rows, own_is_query) == -1)
                        .any())
            assert bool((visit_tiles_plain(padded, padded, T, own_rows, own_is_query) == 0)
                        .any())


def test_visit_rule_distinct_query_and_key_ids():
    """With key ids that differ from the query ids (one id of the keys
    renamed), the rule holds on both sides."""
    T = 256
    q_seg = _segments("packed", T)
    kv_seg = torch.where(q_seg == 2, 3, q_seg).to(torch.int32)
    ok = valid_pairs(q_seg, kv_seg, T)
    for own_is_query in (True, False):
        cls = visit_tiles_plain(q_seg, kv_seg, T, 64, own_is_query)
        valid, _ = _pairs_per_tile(ok, 64, own_is_query)
        assert int(valid[cls == -1].sum()) == 0
        assert bool((valid[cls == 0] == 64 * 64).all())
