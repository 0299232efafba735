"""The port's command line (vallex_tpu_torch/cli.py) on the CPU at toy width:
list-presets prints the JAX package's CLI's names; synthesize and long-text
write 24 kHz WAVs with --device cpu --random-weights --config <tiny>, with
the sampling knobs; make-prompt and ui exit non-zero naming their ROADMAP
item.
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


def test_long_text_writes_a_wav(tiny, tmp_path):
    out = tmp_path / "l.wav"
    assert tcli.main(["long-text", "One. Two.", "--prompt", "paimon", "--mode",
                      "fixed-prompt", "--device", "cpu", "--random-weights", "--config",
                      tiny, "-o", str(out)]) == 0
    assert _frames(out) > 0 and _frames(out) % 320 == 0


@pytest.mark.parametrize("argv,item", [
    (["make-prompt", "me", "clip.wav"], "§1 item 6"), (["ui"], "§1 item 5"),
])
def test_unported_commands_exit_nonzero(capsys, argv, item):
    assert tcli.main(argv) != 0
    assert f"ROADMAP.md {item}" in capsys.readouterr().err


def test_checkpoints_not_ported_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 4"):
        tcli.main(["synthesize", "Hi.", "--device", "cpu", "--checkpoints", str(tmp_path)])
