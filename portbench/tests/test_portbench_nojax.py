"""A run fails, with no result, when JAX, jaxlib, flax or the JAX package
is among the top-level names in sys.modules, compared as whole words (the
port's name begins with the JAX package's), or when no CUDA device is
there."""

import sys
import types

import torch

from portbench import run as R
from portbench.harness.runner import banned_modules


def test_whole_top_level_names(monkeypatch):
    for name in ("vallex_tpu_torch", "vallex_tpu_torch.api", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert banned_modules() == []
    monkeypatch.setitem(sys.modules, "vallex_tpu.engine", types.ModuleType("x"))
    assert banned_modules() == ["vallex_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("y"))
    assert banned_modules() == ["jax", "jaxlib", "vallex_tpu"]


def _argv():
    return ["--workload", "int8kv-offline-b48", "--seed", "1", "--seconds", "1"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(_argv()) != 0
    assert capsys.readouterr().out == ""


def test_jax_loaded_no_result(monkeypatch, capsys):
    import portbench.harness.runner as runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(runner, "run_cell",
                        lambda *a, **k: {"banned": ["jax"], "run": None})
    assert R.main(_argv()) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
