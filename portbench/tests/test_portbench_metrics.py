"""The metric readers' arithmetic on a made-up run, and the trace reading."""

import pytest

from conftest import ROOT
from portbench.harness import trace as T
from portbench.harness.runner import Record, Run
from portbench.harness.spec import load_cell, load_reader
from portbench.harness.traffic import Batch
from portbench.roofline import counts as R


def _rec(wall, ar, nar, vocos, steps, reqs, audio, traced=False):
    b = Batch(0, [], True, 0)
    return Record(b, wall, {"ar": ar, "nar": nar, "vocos": vocos}, steps, reqs, audio, traced)


def _run(trace=None, traced=False):
    cell = load_cell("int8kv-offline-b48", ROOT)
    recs = [_rec(4.0, 3.0, 0.6, 0.2, 800, [(100, 200, 800), (90, 300, 700)], 20.0),
            _rec(6.0, 4.5, 1.0, 0.3, 1000, [(100, 161, 861)], 40.0),
            _rec(9.0, 8.0, 0.5, 0.2, 16, [(100, 161, 10), (100, 161, 16)], 1.0, traced)]
    return Run(cell, 17.5, 3 * 2**30, recs, trace)


def read(name, run):
    return load_reader(ROOT, name)(run)


def test_end_to_end():
    run = _run()
    assert read("audio_s_per_s", run) == pytest.approx(61.0 / 19.0)
    assert read("setup_s", run) == 17.5
    assert read("peak_gib", run) == 3.0


def test_spans_leave_out_the_traced_batch():
    run = _run(traced=True)
    assert read("audio_s_per_s", run) == pytest.approx(60.0 / 10.0)
    assert read("ar_ms_per_step", run) == pytest.approx(1e3 * 7.5 / 1800)
    assert read("nar_share", run) == pytest.approx(100 * 1.6 / 10)
    assert read("vocos_share", run) == pytest.approx(100 * 0.5 / 10)
    m, v = run.model, run.cell.config["vocos"]
    flops = sum(R.request_flops(m, v, q) for q in [(100, 200, 800), (90, 300, 700),
                                                    (100, 161, 861)])
    assert read("mfu", run) == pytest.approx(100 * flops / (10 * R.PEAKS["bf16_flops_per_s"]))


def test_trace_readers():
    kernels = [(0.0, 10.0, "void gemm_tc_kernel<48, 2>(float const*)"),
               (5.0, 20.0, "gemm_prep_kernel"),
               (30.0, 40.0, "void masked_attention_split_kernel<signed char, 64>()"),
               (60.0, 70.0, "sm90_xmma_gemm_bf16bf16"),
               (95.0, 130.0, "elementwise")]
    spans = [(0.0, 50.0, "vallex.ar"), (50.0, 80.0, "vallex.nar")]
    t = T.Trace(0.0, 100.0, kernels, spans)
    assert t.busy_s == pytest.approx(45e-6) and t.window_s == pytest.approx(100e-6)
    # own time: the prep kernel's 5-10 lies under the product kernel before it
    assert t.seconds_matching(r"\bgemm_(tc|prep|ffma)_kernel\b") == pytest.approx(20e-6)
    assert t.seconds_matching(r"nothing") is None
    gaps = dict(t.idle_gaps())
    assert gaps["vallex.ar"] == pytest.approx(10e-6)  # 20-30
    assert gaps["vallex.nar"] == pytest.approx(20e-6)  # 40-60: its middle lies in the span
    assert gaps["between phases"] == pytest.approx(25e-6)  # 70-95: its middle lies past the span
    ops = t.device_ops()
    assert ops[0][0] == "elementwise" and len(ops) == 5
    run = _run(trace=t, traced=True)
    assert read("device_idle_share", run) == pytest.approx(55.0)
    rec = run.traced()
    want = 100 * R.gemm_small_m_bound_s(run.model, 1, [10, 16], 16) / 20e-6
    assert read("gemm_small_m_roofline", run) == pytest.approx(want)
    want = 100 * R.masked_attention_bound_s(run.model, 1, rec.requests, 16) / 10e-6
    assert read("masked_attention_roofline", run) == pytest.approx(want)


def test_nothing_to_read_gives_none():
    run = _run()
    for name in ("device_idle_share", "gemm_small_m_roofline", "masked_attention_roofline"):
        assert read(name, run) is None
    t = T.Trace(0.0, 100.0, [(0.0, 10.0, "elementwise")])
    assert read("gemm_small_m_roofline", _run(trace=t, traced=True)) is None


def test_read_events():
    ev = [{"cat": "user_annotation", "name": "portbench.batch", "ts": 100, "dur": 50},
          {"cat": "user_annotation", "name": "vallex.ar", "ts": 101, "dur": 20},
          {"cat": "kernel", "name": "k", "ts": 110, "dur": 5},
          {"cat": "kernel", "name": "early", "ts": 10, "dur": 5},
          {"cat": "cpu_op", "name": "aten::mm", "ts": 110, "dur": 5}]
    t = T.read(ev, "portbench.batch")
    assert (t.lo, t.hi) == (100.0, 150.0) and [k[2] for k in t.kernels] == ["k"]
    assert [s[2] for s in t.spans] == ["vallex.ar"]
    assert T.read(ev, "missing") is None
    assert T.union_us([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert T.gaps_us([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
