"""The reference against the program's CPU path at a tiny width, the check
failing for each fault a served batch can have, and the control failing
where the program passes.

A whole run is driven with the look for a card skipped (`run_cell` on the
CPU): the window, the check and the metrics, with the configuration's own
limits. At the tiny width, in float32, the program's readings sit far
below those limits, which were set from the full-size runs on the card.
"""

import time

import pytest
import torch

from conftest import make_root
from portbench import control
from portbench.harness.runner import run_cell
from portbench.harness.spec import load_cell


def _run(root, seed=2**31 + 11, seconds=0.5):
    return run_cell(load_cell("tiny", root), seed, seconds, False, "cpu",
                    time.perf_counter())


@pytest.mark.parametrize("quantize", ["none", "int8kv"])
def test_reference_matches_the_program(tmp_path, quantize):
    out = _run(make_root(tmp_path, quantize=quantize))
    c = {k: v["value"] for k, v in out["run"].checks.items()}
    assert out["correct"] and out["failed"] == 0 and out["checked"] >= 2
    # float32 on both sides: only the order of sums differs, except for the
    # int8 weights and K/V of int8kv (about 2^-8 of the logits' spread)
    assert c["ar_gap"] < (1e-3 if quantize == "none" else 2e-2)
    assert c["nar_mean_gap"] < 1e-4
    assert c["wave_err"] < 1e-5


def _alter_ar(monkeypatch):
    import vallex_tpu_torch.engine.pipeline as P

    real = P.ar_generate_batch

    def broken(*a, **k):
        r = real(*a, **k)
        y = r.y_gen.copy()
        y[:, 3] = (y[:, 3] + 1) % 1024  # a token altered where it is produced
        return r._replace(y_gen=y)
    monkeypatch.setattr(P, "ar_generate_batch", broken)


def _alter_nar(monkeypatch):
    import vallex_tpu_torch.engine.pipeline as P

    real = P.nar_generate

    def broken(*a, **k):
        codes = real(*a, **k).clone()
        codes[..., 4] = (codes[..., 4] + 1) % 1024
        return codes
    monkeypatch.setattr(P, "nar_generate", broken)


def _alter_wave(monkeypatch):
    import vallex_tpu_torch.codec.vocos as VC

    real = VC.vocos_decode
    monkeypatch.setattr(VC, "vocos_decode", lambda *a, **k: real(*a, **k) * 1.05)


def _drop_half(monkeypatch):
    import vallex_tpu_torch.engine.pipeline as P

    real = P.SynthesisPipeline.synthesize_batch

    def broken(self, requests, **k):
        r = real(self, requests, **k)
        return r._replace(outputs=r.outputs[: len(r.outputs) // 2])
    monkeypatch.setattr(P.SynthesisPipeline, "synthesize_batch", broken)


def _repeat_state(monkeypatch):
    import vallex_tpu_torch.engine.ar as A

    real = A.decode_block_fused

    def broken(tokens, *a, **k):
        r = real(tokens, *a, **k)  # the block's state comes back unchanged
        return r._replace(fed=tokens.to(r.fed.dtype)[None].expand_as(r.fed),
                          next_tok=tokens.to(r.next_tok.dtype))
    monkeypatch.setattr(A, "decode_block_fused", broken)


def _write_weights(monkeypatch):
    import vallex_tpu_torch.engine.pipeline as P

    real = P.SynthesisPipeline.synthesize_batch

    def broken(self, requests, **k):
        with torch.no_grad():  # the program writes into its own weights
            for p in self.vocos.parameters():
                p.mul_(1.05)
        return real(self, requests, **k)
    monkeypatch.setattr(P.SynthesisPipeline, "synthesize_batch", broken)


@pytest.mark.parametrize("fault", [_alter_ar, _alter_nar, _alter_wave, _drop_half,
                                   _repeat_state, _write_weights])
def test_a_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root = make_root(tmp_path, quantize="none")
    fault(monkeypatch)
    assert not _run(root)["correct"]


@pytest.mark.parametrize("config", ["vallex-int8kv", "vallex-bf16"])
def test_the_control_separates(tmp_path, capsys, config):
    """The control (the reference in the lower precision the configuration
    names) reads each number at least three times what the program reads,
    on three seeds, at the tiny width (the card's test below runs the cell's
    own size)."""
    root = make_root(tmp_path, config=config)
    control.main(["--workload", "tiny", "--seeds", "5,6,7", "--device", "cpu", "--root", root])
    import json

    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 3
    for k in ("ar_gap", "nar_mean_gap", "wave_err"):
        lo = max(r["program"][k] for r in rows)
        up = min(r["control"][k] for r in rows)
        assert up >= 3 * lo, (k, lo, up)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["int8kv-offline-b48", "bf16-offline-b24"])
def test_control_fails_at_the_cell_size(card, capsys, workload):
    """On the card, at the cell's own size: on three seeds the program's
    numbers stay within the configuration's limits and the control's
    break at least one."""
    from conftest import ROOT
    import json

    control.main(["--workload", workload, "--seeds", "101,102,103", "--root", ROOT])
    limits = load_cell(workload, ROOT).config["limits"]
    for r in (json.loads(line) for line in capsys.readouterr().out.splitlines()):
        assert all(r["program"][k] <= limits[k] for k in limits)
        assert any(r["control"][k] > limits[k] for k in limits)
    torch.cuda.empty_cache()
