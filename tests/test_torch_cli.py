"""The port's command line (vallex_tpu_torch/cli.py) on the CPU at toy width:
list-presets prints the JAX package's CLI's names; synthesize and long-text
write 24 kHz WAVs with --device cpu --random-weights --config <tiny>, with
the sampling knobs and --quantize (the JAX CLI's four values); ui without
gradio raises the UI's message; --checkpoints with no checkpoint in it
raises as the JAX CLI does (make-prompt: tests/test_torch_encodec.py).
"""

import json
import subprocess
import sys
import wave as wave_mod
from pathlib import Path

import pytest
import torch

from vallex_tpu import cli as jcli
from vallex_tpu_torch import cli as tcli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = {"model": {"d_model": 64, "num_heads": 4, "num_layers": 2, "ffn_dim": 128},
        "engine": {"text_buckets": [64, 128], "audio_buckets": [128, 256, 512],
                   "compute_dtype": "float32"}}


@pytest.fixture()
def tiny(tmp_path):
    p = tmp_path / "tiny.json"
    p.write_text(json.dumps(TINY))
    return str(p)


def _frames(path):
    with wave_mod.open(str(path)) as f:
        assert f.getframerate() == 24000 and f.getnchannels() == 1
        return f.getnframes()


def test_list_presets_equals_jax_cli(capsys):
    assert jcli.main(["list-presets"]) == 0
    want = capsys.readouterr().out.split()
    assert tcli.main(["list-presets"]) == 0
    got = capsys.readouterr().out.split()
    assert got == want and "paimon" in got and len(got) >= 41


def test_synthesize_subprocess_writes_a_24khz_wav(tiny, tmp_path):
    """`python -m vallex_tpu_torch.cli synthesize` as a user runs it."""
    out = tmp_path / "o.wav"
    r = subprocess.run(
        [sys.executable, "-m", "vallex_tpu_torch.cli", "synthesize", "Hi.", "--device", "cpu",
         "--random-weights", "--config", tiny, "--top-k", "1", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"wrote {out}" in r.stdout
    assert _frames(out) > 0 and _frames(out) % 320 == 0


@pytest.mark.parametrize("knobs", [["--best-of", "2"], ["--top-k", "5", "--top-p", "0.9"]],
                         ids=["best_of", "filtered"])
def test_synthesize_knobs(tiny, tmp_path, knobs):
    out = tmp_path / "k.wav"
    assert tcli.main(["synthesize", "Hi there.", "--prompt", "paimon", "--device", "cpu",
                      "--random-weights", "--config", tiny, "-o", str(out), *knobs]) == 0
    assert _frames(out) > 0 and _frames(out) % 320 == 0


def _quantize_choices(main, argv, capsys):
    with pytest.raises(SystemExit):
        main([*argv, "--quantize", "bogus"])
    err = capsys.readouterr().err
    return err[err.index("choose from"):].split(")")[0]


@pytest.mark.parametrize("cmd", ["synthesize", "long-text", "serve"])
def test_quantize_choices_equal_jax_cli(capsys, cmd):
    """--quantize takes the JAX CLI's four values (vallex_tpu/cli.py:134-136)
    on synthesize, long-text and serve."""
    want = _quantize_choices(jcli.main, ["serve"], capsys)
    assert want == "choose from none, int8, w8a8, int8kv"
    argv = [cmd] + (["Hi."] if cmd != "serve" else [])
    assert _quantize_choices(tcli.main, argv, capsys) == want


def test_synthesize_quantize_int8kv_on_cpu(tmp_path):
    """synthesize --quantize int8kv on the kernel path's ops (plain versions
    on the CPU): the engine runs int8 weights and an int8 KV cache in K-step
    blocks and writes a 24 kHz WAV."""
    from vallex_tpu_torch import api

    cfg = tmp_path / "tiny_kernels.json"
    cfg.write_text(json.dumps({"model": TINY["model"],
                               "engine": {**TINY["engine"], "decode_mode": "megakernel"}}))
    out = tmp_path / "q.wav"
    assert tcli.main(["synthesize", "Hi.", "--device", "cpu", "--random-weights", "--config",
                      str(cfg), "--top-k", "1", "--quantize", "int8kv", "-o", str(out)]) == 0
    assert api._bundle.ecfg.quantize == "int8kv"
    res = api._bundle.last
    assert res.ar.iterations < len(res.codes)  # K frames per block
    assert _frames(out) == len(res.codes) * 320 > 0


def test_long_text_writes_a_wav(tiny, tmp_path):
    out = tmp_path / "l.wav"
    assert tcli.main(["long-text", "One. Two.", "--prompt", "paimon", "--mode",
                      "fixed-prompt", "--device", "cpu", "--random-weights", "--config",
                      tiny, "-o", str(out)]) == 0
    assert _frames(out) > 0 and _frames(out) % 320 == 0


@pytest.mark.parametrize("argv,item", [
    pytest.param(["ui"], "§1 item 5", id="argv1-§1 item 5"),
])
def test_unported_commands_exit_nonzero(tiny, argv, item):
    """ROADMAP.md §1 item 5, the gradio UI, is ported: with no gradio
    installed `ui` raises the UI's RuntimeError naming the CLI, where it
    exited 2 (tests/test_torch_ui.py builds the UI through a stub gradio)."""
    had = sys.modules.pop("gradio", None)
    sys.modules["gradio"] = None  # import gradio raises ImportError
    try:
        with pytest.raises(RuntimeError, match="gradio is not installed.*cli synthesize"):
            tcli.main(argv + ["--device", "cpu", "--random-weights", "--config", tiny])
    finally:
        if had is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = had


def test_checkpoints_not_ported_raise(tmp_path):
    """--checkpoints naming a directory with no checkpoint (and no
    --random-weights) raises FileNotFoundError with the JAX package's
    wording; reading checkpoints: tests/test_torch_checkpoint.py."""
    with pytest.raises(FileNotFoundError, match="No checkpoint in .*random_weights=True"):
        tcli.main(["synthesize", "Hi.", "--device", "cpu", "--checkpoints", str(tmp_path)])
