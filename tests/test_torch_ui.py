"""The port's gradio UI (vallex_tpu_torch/ui.py) and its example rows, against
the JAX package's, through a stub `gradio` module (gradio is not
installed): both UIs build the same graph (tabs, components with their
labels, choices and defaults, and each click's input and output arity);
the port's four callbacks return (24000, a finite wave) at toy width on the
CPU; a temporary prompt older than 60 s is removed; without gradio
launch_ui raises RuntimeError, and `cli ui` builds the UI when gradio is
there."""

import json
import math
import os
import sys
import types

import numpy as np
import pytest

from vallex_tpu import examples as jexamples
from vallex_tpu import ui as jui
from vallex_tpu_torch import api, cli, examples, ui
from vallex_tpu_torch.config import EngineConfig, ModelConfig
from vallex_tpu_torch.utils.audio import save_wav

TINY = {"d_model": 64, "num_heads": 4, "num_layers": 2, "ffn_dim": 128}
ENGINE = {"text_buckets": [64, 128], "audio_buckets": [128, 256, 512],
          "compute_dtype": "float32"}


class _Component:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        _REGISTRY["components"].append(
            (_REGISTRY["current_tab"], type(self).__name__, args, kwargs))

    def click(self, fn, inputs, outputs):
        _REGISTRY["clicks"].append({"fn": fn, "inputs": inputs, "outputs": outputs,
                                    "tab": _REGISTRY["current_tab"]})


class _Ctx(_Component):
    def __enter__(self):
        if self.args and isinstance(self.args[0], str):  # Tab
            _REGISTRY["current_tab"] = self.args[0]
            _REGISTRY["tabs"].append(self.args[0])
        return self

    def __exit__(self, *exc):
        _REGISTRY["current_tab"] = None
        return False

    def launch(self, **kwargs):
        _REGISTRY["launch_kwargs"] = kwargs


_REGISTRY = {}


@pytest.fixture()
def fake_gradio():
    had = sys.modules.get("gradio")
    gr = types.ModuleType("gradio")
    gr.Blocks = type("Blocks", (_Ctx,), {})
    gr.Tab = type("Tab", (_Ctx,), {})
    for name in ("Markdown", "TextArea", "Audio", "Dropdown", "File", "Button"):
        setattr(gr, name, type(name, (_Component,), {}))
    sys.modules["gradio"] = gr

    def build(launch):
        _REGISTRY.clear()
        _REGISTRY.update({"clicks": [], "tabs": [], "components": [], "current_tab": None,
                          "launch_kwargs": None})
        launch()
        return dict(_REGISTRY)

    yield build
    if had is None:
        sys.modules.pop("gradio", None)
    else:
        sys.modules["gradio"] = had


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return api.preload_models(str(tmp_path_factory.mktemp("empty")), random_weights=True,
                              cfg=ModelConfig(**TINY),
                              ecfg=EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                                                   for k, v in ENGINE.items()}),
                              device="cpu")


def test_examples_equal_jax():
    assert examples.infer_from_prompt_examples == jexamples.infer_from_prompt_examples
    assert examples.long_text_example == jexamples.long_text_example
    for name in ("infer_from_audio_md", "make_prompt_md", "infer_from_prompt_md",
                 "long_text_md"):
        assert getattr(examples, name) == getattr(jexamples, name)
    assert "PyTorch" in examples.top_md and "JAX" not in examples.top_md


def test_ui_graph_equals_jax(fake_gradio):
    """Tabs, components (type, labels, choices, defaults) and clicks (input
    and output arity, callback parameters) as the JAX package's; only the
    top Markdown (the package's own description) differs."""
    import inspect

    want = fake_gradio(lambda: jui.launch_ui(port=7861))
    got = fake_gradio(lambda: ui.launch_ui(port=7861))
    assert got["tabs"] == want["tabs"] == [
        "Infer from audio", "Make prompt", "Infer from prompt", "Long text"]
    top = [(None, "Markdown", (jexamples.top_md,), {})]
    assert [c for c in want["components"] if c not in top] == [
        c for c in got["components"] if c != (None, "Markdown", (examples.top_md,), {})]
    assert len(got["components"]) == len(want["components"])
    assert len(got["clicks"]) == len(want["clicks"]) == 4
    for g, w in zip(got["clicks"], want["clicks"]):
        assert g["tab"] == w["tab"]
        assert len(g["inputs"]) == len(w["inputs"]) == len(
            inspect.signature(g["fn"]).parameters)
        assert len(g["outputs"]) == len(w["outputs"]) == 1
        assert list(inspect.signature(g["fn"]).parameters) == list(
            inspect.signature(w["fn"]).parameters)
    assert got["launch_kwargs"] == {"server_port": 7861}
    presets = [c for c in got["components"] if c[3].get("label") == "voice prompt"][0][2][0]
    assert "paimon" in presets


def _clip(path, seconds=1.0):
    rng = np.random.RandomState(0)
    save_wav(str(path), (0.1 * rng.randn(int(24000 * seconds))).astype(np.float32))
    return str(path)


def test_callbacks_run_on_the_cpu(fake_gradio, bundle, tmp_path, monkeypatch):
    """Each tab's callback on the toy bundle: (24000, finite wave), or the
    prompt file it made."""
    monkeypatch.chdir(tmp_path)  # make_npz writes ./customs
    reg = fake_gradio(lambda: ui.launch_ui(port=7862))
    cb = {c["tab"]: c["fn"] for c in reg["clicks"]}
    clip = _clip(tmp_path / "clip.wav")
    outs = [cb["Infer from prompt"]("Hi.", "paimon", "auto-detect", "no-accent"),
            cb["Infer from audio"]("Hi.", clip, "Hello.", "en", "no-accent"),
            cb["Long text"]("One. Two.", "paimon", "fixed-prompt")]
    for sr, wave in outs:
        assert sr == 24000 and wave.ndim == 1 and len(wave) > 0 and np.isfinite(wave).all()
    npz = cb["Make prompt"]("me", clip, "Hello.")
    assert os.path.exists(npz) and npz.endswith("me.npz")
    assert api._bundle.last.ar.beam_tokens.shape[0] == 5  # the UI's best_of


def test_stale_temp_prompt_removed(fake_gradio, bundle, tmp_path, monkeypatch):
    """A prompt that "Infer from audio" made is deleted by the next call once
    older than 60 s (the clock monkeypatched)."""
    reg = fake_gradio(lambda: ui.launch_ui(port=7863))
    infer = [c["fn"] for c in reg["clicks"] if c["tab"] == "Infer from audio"][0]
    made = []
    orig = api.make_prompt
    monkeypatch.setattr(api, "make_prompt", lambda *a, **k: made.append(orig(*a, **k)) or made[-1])
    clock = [1000.0]
    monkeypatch.setattr(ui.time, "time", lambda: clock[0])
    clip = _clip(tmp_path / "clip.wav")
    infer("Hi.", clip, "Hello.", "en", "no-accent")
    assert os.path.exists(made[0])
    clock[0] += 30.0
    infer("Hi.", clip, "Hello.", "en", "no-accent")
    assert os.path.exists(made[0])  # 30 s old: kept
    clock[0] += 31.0
    infer("Hi.", clip, "Hello.", "en", "no-accent")
    assert not os.path.exists(made[0]) and os.path.exists(made[1])
    assert math.isclose(clock[0] - 1000.0, 61.0)


def test_launch_ui_without_gradio_raises():
    had = sys.modules.pop("gradio", None)
    sys.modules["gradio"] = None  # import gradio raises ImportError
    try:
        with pytest.raises(RuntimeError, match="gradio is not installed.*vallex_tpu_torch.cli"):
            ui.launch_ui()
    finally:
        if had is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = had


def test_cli_ui_launches(fake_gradio, tmp_path):
    """`cli ui --port` loads the model and launches the UI on that port (it
    exited 2 while the UI was not ported)."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": TINY, "engine": ENGINE}))
    rc = []
    reg = fake_gradio(lambda: rc.append(cli.main(
        ["ui", "--port", "7999", "--device", "cpu", "--random-weights", "--config", str(cfg),
         "--checkpoints", str(tmp_path)])))
    assert rc == [0] and reg["launch_kwargs"] == {"server_port": 7999}
    assert len(reg["clicks"]) == 4
