"""The AR decode layer's readers of the program's own spans and counters
(`ar_decode_ms_per_step`, `ar_prefill_share`, `ar_host_wait_share`,
`ar_wrapper_ms_per_step`, `ar_launches_per_step`) on a made-up run, and
their None on a run whose seconds or spans lack what they read."""

import pytest

from conftest import ROOT
from portbench.harness import trace as T
from portbench.harness.runner import Record, Run
from portbench.harness.spec import load_cell, load_reader
from portbench.harness.traffic import Batch

NAMES = ("ar_decode_ms_per_step", "ar_prefill_share", "ar_host_wait_share",
         "ar_wrapper_ms_per_step", "ar_launches_per_step")
BARE = {"ar": 3.0, "nar": 0.6, "vocos": 0.2}  # what the pipeline returned before these keys


def _rec(wall, steps, prefill, decode, wait, wrappers, traced=False):
    b = Batch(0, [], True, 0)
    seconds = dict(BARE, ar_prefill=prefill, ar_decode=decode, ar_wait=wait,
                   ar_wrappers=wrappers)
    return Record(b, wall, seconds, steps, [(100, 200, steps)], 10.0, traced)


def _trace():
    """A decode span over [100, 300) µs of two blocks, each closed by a read,
    on a device clock that runs 15 µs early: the first decode events show
    before the span opens and the finish's first kernels before it closes."""
    kernels = [(20.0, 60.0, "prefill gemm"),
               (80.0, 82.0, "Memcpy DtoH (Device -> Pinned)"),  # the prefill's host read
               (90.0, 95.0, "void at::native::elementwise_kernel<128, 2>"),  # block 1
               (110.0, 120.0, "void gemm_tc_kernel<1, 3>()"),
               (155.0, 156.0, "Memcpy DtoH (Device -> Pinned)"),  # block 1's read
               (175.0, 180.0, "masked_attention_split_kernel"),  # block 2
               (200.0, 210.0, "sample_epilogue_draw_kernel"),
               (285.0, 286.0, "Memcpy DtoH (Device -> Pinned)"),  # block 2's read
               (290.0, 292.0, "finish cumprod"), (294.0, 296.0, "finish sum"),
               (320.0, 321.0, "Memcpy DtoH (Device -> Pageable)"),  # the finish's copies
               (400.0, 410.0, "nar gemm"), (420.0, 421.0, "Memcpy DtoH (Device -> Pageable)")]
    spans = [(0.0, 500.0, "vallex.ar"), (10.0, 95.0, "vallex.ar.prefill"),
             (100.0, 300.0, "vallex.ar.decode"), (100.0, 150.0, "vallex.ar.block"),
             (150.0, 170.0, "vallex.ar.read"), (170.0, 260.0, "vallex.ar.block"),
             (260.0, 300.0, "vallex.ar.read"), (300.0, 350.0, "vallex.ar.finish")]
    return T.Trace(0.0, 500.0, kernels, spans)


def _run(recs, trace=None):
    return Run(load_cell("int8kv-offline-b48", ROOT), 17.5, 2**30, recs, trace)


def read(name, run):
    return load_reader(ROOT, name)(run)


def test_untraced_counters():
    run = _run([_rec(4.0, 800, 0.25, 2.4, 0.6, 0.9),
                _rec(6.0, 1000, 0.35, 3.6, 1.4, 1.2),
                _rec(9.0, 16, 5.0, 5.0, 4.0, 0.5, traced=True)], _trace())
    assert read("ar_decode_ms_per_step", run) == pytest.approx(1e3 * 6.0 / 1800)
    assert read("ar_prefill_share", run) == pytest.approx(100 * 0.6 / 10.0)
    assert read("ar_host_wait_share", run) == pytest.approx(100 * 2.0 / 6.0)
    assert read("ar_wrapper_ms_per_step", run) == pytest.approx(1e3 * 2.1 / 1800)


def test_launches_run_from_the_prefill_read_to_the_last_block_read():
    """The loop's events in device order, after the prefill's copy up to
    and including the last block's copy: 6 over the batch's 16 steps,
    where cutting at the span's host times would drop block 1's first
    event and take the finish's two kernels."""
    run = _run([_rec(4.0, 800, 0.25, 2.4, 0.6, 0.9),
                _rec(9.0, 16, 5.0, 5.0, 4.0, 0.5, traced=True)], _trace())
    assert read("ar_launches_per_step", run) == pytest.approx(6 / 16)


def test_parent_runs_read_none():
    """A run without the AR's keys and spans (the program before them)
    gives None from every reader, and raises nothing."""
    b = Batch(0, [], True, 0)
    recs = [Record(b, 4.0, dict(BARE), 800, [(100, 200, 800)], 10.0),
            Record(b, 9.0, dict(BARE), 16, [(100, 200, 16)], 1.0, True)]
    t = _trace()
    bare = T.Trace(t.lo, t.hi, t.kernels, [s for s in t.spans if s[2] == "vallex.ar"])
    for trace in (None, bare):
        run = _run(recs, trace)
        assert [read(n, run) for n in NAMES] == [None] * 5


def test_launches_need_a_traced_batch_and_its_copies():
    run = _run([_rec(4.0, 800, 0.25, 2.4, 0.6, 0.9)], _trace())
    assert read("ar_launches_per_step", run) is None
    run = _run([_rec(4.0, 800, 0.25, 2.4, 0.6, 0.9, traced=True)])
    assert read("ar_launches_per_step", run) is None
    t = _trace()
    for keep in (lambda n: not n.startswith("Memcpy"),  # no copies at all
                 lambda n: not n.endswith("Pinned)")):  # none before the finish's
        bare = T.Trace(t.lo, t.hi, [k for k in t.kernels if keep(k[2])], t.spans)
        run = _run([_rec(9.0, 16, 5.0, 5.0, 4.0, 0.5, traced=True)], bare)
        assert read("ar_launches_per_step", run) is None


def test_entries_name_the_readers():
    """Each reader is a `per_layer` entry of both cells, on the AR's layer."""
    for w in ("int8kv-offline-b48", "bf16-offline-b24"):
        assert set(NAMES) <= {m.name for m in load_cell(w, ROOT).per_layer}
