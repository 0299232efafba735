"""The traffic generator: the same seed gives the same batches, the lengths
and prompts follow the traffic file, and the caps follow the program's rule."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import PRESETS, ROOT
from portbench.harness.runner import run_batch
from portbench.harness.traffic import Traffic, gen_cap, load_prompts


def _spec(name="offline-b48"):
    with open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _batches(spec, seed, n, stream=0):
    t = Traffic(spec, seed, ROOT, stream=stream)
    return [t.next_batch() for _ in range(n)]


def _same(a, b):
    return (a.greedy == b.greedy and a.seed == b.seed and len(a.requests) == len(b.requests)
            and all(all(np.array_equal(x, y) for x, y in zip(ra, rb))
                    for ra, rb in zip(a.requests, b.requests)))


@pytest.mark.parametrize("name", ["offline-b48", "offline-b24"])
def test_same_seed_same_batches(name):
    seed = 2**31 + 977  # more than 32 signed bits
    a, b = _batches(_spec(name), seed, 3), _batches(_spec(name), seed, 3)
    assert all(_same(x, y) for x, y in zip(a, b))
    c = _batches(_spec(name), seed + 1, 3)
    assert not all(_same(x, y) for x, y in zip(a, c))
    warm = _batches(_spec(name), seed, 1, stream=1)[0]
    assert not _same(warm, a[0])


def test_b48_holds_every_prompt_and_the_lengths():
    spec = _spec("offline-b48")
    prompts = load_prompts(ROOT, spec)
    assert len(prompts) == 41
    assert min(len(p[0]) for p in prompts) == 161 and max(len(p[0]) for p in prompts) == 758
    t = Traffic(spec, 12345, ROOT)
    for b in (t.next_batch() for _ in range(4)):
        assert len(b.requests) == 48
        lens = sorted(len(p) for _, _, p in b.requests)
        assert lens[0] == 161 and lens[-1] == 758
        assert len({len(p) for _, _, p in b.requests}) <= 41
        by_audio = {id(q[0]): q for q in t.prompts}
        for text, lang, prompt in b.requests:
            _, tt, lg = by_audio[id(prompt)]
            new = len(text) - len(tt)
            assert 64 <= new <= 96 and np.array_equal(text[: len(tt)], tt)
            assert text[len(tt):].min() >= 1 and text[len(tt):].max() <= 69
            assert (lang == lg).all() and len(lang) == len(text) <= 256
            # the bucket, not the text, caps every request: 1022 - prompt frames
            assert gen_cap(len(text), len(prompt), [1024]) == 1022 - len(prompt)


def test_first_batch_greedy_then_the_engine_samples():
    spec = _spec("offline-b24")
    bs = _batches(spec, 7, 6)
    assert [b.greedy for b in bs] == [True] + [False] * 5
    # the traffic file holds what a mix varies; sampling is the engine's
    assert not {"top_k", "temperature", "greedy_every"} & set(spec)

    class Pipeline:
        def synthesize_batch(self, requests, **k):
            calls.append(k)
            return SimpleNamespace(outputs=[], seconds={}, ar=None)

    calls = []
    for b in bs[:2]:
        run_batch(Pipeline(), b, 8)
    assert [c["top_k"] for c in calls] == [1, None]
    assert all("temperature" not in c and c["return_wave"] for c in calls)
    # one prompt from each 24th of the lengths: every batch spans them all
    for b in _batches(spec, 7, 5):
        lens = sorted(len(p) for _, _, p in b.requests)
        assert len(lens) == 24 and lens[0] <= 162 and lens[-1] >= 749


def test_gen_cap_rule():
    assert gen_cap(64, 161, [1024]) == 861
    assert gen_cap(10, 100, [1024]) == 160  # 16 · x_len first
    assert gen_cap(40, 225, [512]) == 285
    assert gen_cap(40, 100, [256, 512]) == 410  # the smallest bucket that holds it


def test_prompt_filter(tmp_path):
    spec = dict(_spec(), prompts=PRESETS, prompt_frames=[1, 200])
    assert {len(p[0]) for p in load_prompts(ROOT, spec)} == {161, 162, 177, 191, 198}
