"""Each device event's own time (harness/trace.py): clipped to the end of the
events before it on its own stream, never against another stream's, and
summing to its stream's union."""

import random

import pytest

from portbench.harness import trace as T


def test_overlap_on_one_stream_is_clipped():
    """A kernel started early by programmatic dependent launch (5-20 under
    0-10), one wholly under its predecessor (12-14 under 5-20) and one
    after a gap (30-40)."""
    kernels = [(0.0, 10.0, "gemm_tc_kernel"), (5.0, 20.0, "gemm_prep_kernel"),
               (12.0, 14.0, "masked_attention_split_kernel"), (30.0, 40.0, "gemm_tc_kernel")]
    t = T.Trace(0.0, 100.0, kernels, [], [7, 7, 7, 7])
    assert [(a, b) for a, b, _ in t.own()] == [(0.0, 10.0), (10.0, 20.0), (14.0, 14.0),
                                               (30.0, 40.0)]
    assert t.seconds_matching(r"gemm_tc") == pytest.approx(20e-6)
    assert t.seconds_matching(r"gemm_prep") == pytest.approx(10e-6)
    assert t.seconds_matching(r"masked_attention") == 0.0
    assert dict(t.device_ops()) == pytest.approx({"gemm_tc_kernel": 20e-6,
                                                  "gemm_prep_kernel": 10e-6,
                                                  "masked_attention_split_kernel": 0.0})
    assert t.busy_s == pytest.approx(30e-6)  # the union, as before


def test_two_streams_are_not_clipped_against_each_other():
    """The same overlap read from a chrome trace with the two kernels on two
    streams (`args.stream`, else `tid`): each keeps its whole span."""
    ev = [{"cat": "user_annotation", "name": "portbench.batch", "ts": 0, "dur": 100},
          {"cat": "kernel", "name": "gemm_tc_kernel", "ts": 0, "dur": 10,
           "args": {"stream": 7}, "tid": 7},
          {"cat": "kernel", "name": "gemm_prep_kernel", "ts": 5, "dur": 15,
           "args": {"stream": 13}, "tid": 13},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 15, "dur": 10, "tid": 13}]
    t = T.read(ev, "portbench.batch")
    assert t.streams == [7, 13, 13]
    assert t.seconds_matching(r"gemm_tc") == pytest.approx(10e-6)
    assert t.seconds_matching(r"gemm_prep") == pytest.approx(15e-6)
    assert t.seconds_matching(r"Memcpy") == pytest.approx(5e-6)  # 20-25 after the prep
    assert t.busy_s == pytest.approx(25e-6)


def test_own_times_sum_to_the_stream_union():
    rng = random.Random(5)
    kernels, streams = [], []
    for _ in range(400):
        a = rng.uniform(-20.0, 1000.0)
        kernels.append((a, a + rng.expovariate(1 / 8.0), "k"))
        streams.append(rng.choice("ab"))
    t = T.Trace(0.0, 900.0, kernels, [], streams)
    own = t.own()
    for s in "ab":
        mine = [i for i in range(len(kernels)) if streams[i] == s]
        total = sum(max(0.0, min(own[i][1], t.hi) - max(own[i][0], t.lo)) for i in mine)
        union = T.union_us([kernels[i][:2] for i in mine], t.lo, t.hi)
        assert total == pytest.approx(union, rel=1e-12)
    assert t.seconds_matching("k") * 1e6 == pytest.approx(
        sum(T.union_us([k[:2] for k, s in zip(kernels, streams) if s == x], t.lo, t.hi)
            for x in "ab"), rel=1e-12)
