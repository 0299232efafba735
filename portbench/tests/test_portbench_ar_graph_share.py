"""The reader of `ar_graph_share` (replayed blocks of the batched AR's
decode loop over the blocks run, in %) on made-up runs, and its None on a
run whose seconds lack the program's `ar_graph_blocks` counter."""

import pytest

from conftest import ROOT
from portbench.harness.runner import Record, Run
from portbench.harness.spec import load_cell, load_reader
from portbench.harness.traffic import Batch

BARE = {"ar": 3.0, "nar": 0.6, "vocos": 0.2}  # what the pipeline returned before the counter


def _rec(wall, steps, traced=False, **graph):
    b = Batch(0, [], True, 0)
    return Record(b, wall, dict(BARE, **graph), steps, [(100, 200, steps)], 10.0, traced)


def _run(recs):
    return Run(load_cell("int8kv-offline-b48", ROOT), 17.5, 2**30, recs, None)


def _share(recs):
    return load_reader(ROOT, "ar_graph_share")(_run(recs))


def test_graph_share_counts_replayed_blocks():
    """Replayed blocks over the blocks the untraced batches ran (steps / K,
    K = 8 in the cell): 100 when every block replays, 0 on the CPU's eager
    loop, between when a batch ran eagerly; the traced batch is left out."""
    full = [_rec(4.0, 800, ar_graph_blocks=100, ar_graph_capture=0.05),
            _rec(6.0, 1000, ar_graph_blocks=125, ar_graph_capture=0.04),
            _rec(9.0, 16, traced=True, ar_graph_blocks=0)]
    assert _share(full) == pytest.approx(100.0)
    eager = [_rec(4.0, 800, ar_graph_blocks=0, ar_graph_capture=0.0)]
    assert _share(eager) == 0.0
    assert _share(full[:1] + eager) == pytest.approx(50.0)


def test_parent_runs_read_none():
    """A run without the counter (the program before it) gives None, and
    raises nothing; so does a run with no untraced batch."""
    assert _share([_rec(4.0, 800), _rec(6.0, 1000)]) is None
    assert _share([_rec(9.0, 16, traced=True, ar_graph_blocks=2)]) is None
