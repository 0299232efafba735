"""Fixtures of the benchmark's tests: a checkout at a tiny width (the
program's CPU path and the reference agree there), and the `card` marker
for tests that need a CUDA device.

Run: python -m pytest portbench/tests -q   (from the checkout's root)
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PRESETS = os.path.join(ROOT, "vallex_tpu_torch", "assets", "presets")
TINY_MODEL = dict(d_model=64, num_heads=4, num_layers=2, ffn_dim=128)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest portbench/tests -m card")


def make_root(tmp, config="vallex-int8kv", traffic="offline-b48", quantize=None, batch=3):
    """A checkout holding BENCHMARK.json, one cell `tiny` over a copy of the
    named configuration at a tiny width (f32 on the CPU) and of the named
    traffic with `batch` requests of short prompts, and the real metrics."""
    root = str(tmp)
    pb = os.path.join(root, "portbench")
    os.makedirs(os.path.join(pb, "configs"), exist_ok=True)
    os.makedirs(os.path.join(pb, "traffic"), exist_ok=True)
    if not os.path.exists(os.path.join(pb, "metrics")):
        shutil.copytree(os.path.join(ROOT, "portbench", "metrics"), os.path.join(pb, "metrics"))
    with open(os.path.join(ROOT, "portbench", "configs", f"{config}.json")) as f:
        conf = json.load(f)
    conf["model"].update(TINY_MODEL)
    conf["engine"].update(audio_buckets=[512], text_buckets=[128], compute_dtype="float32")
    if quantize is not None:
        conf["engine"]["quantize"] = quantize
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(ROOT, "portbench", "traffic", f"{traffic}.json")) as f:
        t = json.load(f)
    t.update(batch=batch, prompts=PRESETS, prompt_frames=[1, 230], text_phonemes=[8, 12])
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="tiny", file="portbench/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name="tiny", config="tiny",
                               traffic="tiny")]
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
