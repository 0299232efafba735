"""The Granite-4.0-H architecture (archs/granite4h.py, reference/granite4h.py,
configs/granite-4.0-h-micro-bf16.json) at a tiny width on the CPU: the
reference's quadratic form against its recurrence, the reference importing
neither JAX nor the program, a run of the cell through run_cell, and its
two metrics' readers."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import PRESETS, ROOT
from portbench.harness import trace as T
from portbench.harness.runner import Record, Run, run_cell
from portbench.harness.spec import load_arch, load_cell, load_reader
from portbench.harness.traffic import Batch
from portbench.reference import granite4h as RG
from portbench.run import result_line

CELL = "granite4h-bf16-offline-b48"
TINY_AR = dict(hidden_size=64, intermediate_size=96, shared_intermediate_size=96,
               num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8, mamba_d_head=16,
               mamba_d_state=16, mamba_chunk_size=8, num_hidden_layers=4,
               layer_types=["mamba", "mamba", "attention", "mamba"])


def test_quadratic_form_equals_recurrence():
    """ssd_quadratic (the reference's exact form) equals the recurrence; the
    state rounded to bfloat16 moves it."""
    g = torch.Generator().manual_seed(0)
    L, H, P, N = 37, 3, 4, 5
    x = torch.randn((L, H, P), generator=g)
    dt = torch.rand((L, H), generator=g) * 0.2
    A = -(1 + 15 * torch.rand(H, generator=g))
    B, C = torch.randn((L, N), generator=g), torch.randn((L, N), generator=g)
    y = RG.ssd_recurrent(x, dt, A, B, C)
    torch.testing.assert_close(RG.ssd_quadratic(x, dt, A, B, C), y, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(RG.ssd_recurrent(x, dt, A, B, C, state_dtype=torch.bfloat16), y,
                              atol=1e-5, rtol=1e-5)


def test_reference_imports_no_jax_nor_program():
    code = ("import sys; import portbench.reference.granite4h as r; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vallex_tpu', 'vallex_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def _tiny_root(tmp):
    """A checkout with the cell over a tiny-width copy of the configuration
    (f32 on the CPU) and traffic of 3 short requests."""
    root = str(tmp)
    pb = os.path.join(root, "portbench")
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(pb, sub), exist_ok=True)
    os.symlink(os.path.join(ROOT, "portbench", "metrics"), os.path.join(pb, "metrics"))
    with open(os.path.join(ROOT, "portbench", "configs", "granite-4.0-h-micro-bf16.json")) as f:
        conf = json.load(f)
    m = conf["model"]
    m.update(d_model=32, num_heads=2, num_layers=2, ffn_dim=64)
    m["ar_stack"].update(TINY_AR)
    conf["engine"].update(audio_buckets=[512], text_buckets=[128], compute_dtype="float32")
    conf["limits"]["ar_gap"] = 1e-4  # f32 against f32
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(ROOT, "portbench", "traffic", "offline-b48.json")) as f:
        t = json.load(f)
    t.update(batch=3, prompts=PRESETS, prompt_frames=[1, 230], text_phonemes=[8, 12])
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    conf_entry = next(c for c in bench["configs"] if c["name"] == "granite-4.0-h-micro-bf16")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    bench["configs"] = [dict(conf_entry, file="portbench/configs/tiny.json")]
    bench["workloads"] = [dict(cell, traffic="tiny")]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_cell_runs_on_the_cpu(tmp_path):
    """The cell at a tiny width through run_cell: correct, every request at
    its cap, the scans' share read, the roofline left out untraced."""
    root = _tiny_root(tmp_path)
    cell = load_cell(CELL, root)
    out = run_cell(cell, 2**31 + 77, 0.5, False, "cpu", time.perf_counter(), log=lambda m: None)
    assert out["correct"] and out["failed"] == 0 and out["checked"] >= 2
    run = out["run"]
    assert all(g > 0 for r in run.records for _, _, g in r.requests)
    assert all("ar_scan" in r.seconds and r.seconds["ar_state_bytes"] > 0 for r in run.records)
    line = result_line(out, cell, trace=True)
    assert line["metrics"]["ar_scan_share"]["value"] > 0
    assert "ssm_step_roofline" not in line["metrics"]  # no device trace on the CPU
    assert run.checks["ar_gap"]["value"] < 1e-4


def test_ssm_step_roofline_reads_the_kernel(tmp_path):
    """ssm_step_roofline: the architecture's bound over ssm_step_kernel's own
    time; None under VALL-E X (no bound) and where the kernel is absent."""
    root = _tiny_root(tmp_path)
    cell = load_cell(CELL, root)
    read = load_reader(root, "ssm_step_roofline")
    kernels = [(0.0, 10.0, "ssm_step_kernel(float const*, int)"),
               (10.0, 30.0, "void gemm_tc_kernel<48, 2>(float const*)")]
    recs = [Record(Batch(1, [], False, 0), 9.0, {}, 16, [(100, 161, 16)] * 2, 1.0, True)]
    run = Run(cell, 1.0, None, recs, T.Trace(0.0, 100.0, kernels, []))
    want = 100.0 * cell.arch.ssm_step_bound_s(cell.config["model"], 2, 16) / 10e-6
    assert read(run) == pytest.approx(want)
    assert read(Run(cell, 1.0, None, recs, T.Trace(0.0, 100.0, kernels[1:], []))) is None
    vallex = Run(cell, 1.0, None, recs, T.Trace(0.0, 100.0, kernels, []))
    vallex.cell.arch = load_arch(ROOT, "vallex")
    assert read(vallex) is None


def test_ssm_step_bytes_at_the_published_widths():
    """48 rows × 36 layers × 2 MiB of f32 state read and written dominate the
    step's bytes (7.25 GB of 7.27 GB)."""
    arch = load_arch(ROOT, "granite4h")
    with open(os.path.join(ROOT, "portbench", "configs", "granite-4.0-h-micro-bf16.json")) as f:
        model = json.load(f)["model"]
    per = arch.ssm_step_bytes(model)
    assert per == 4 * (2 * 64 * 64 * 128 + 3 * 64 * 64 + 2 * 128 + 64)
    assert 48 * 36 * per == pytest.approx(7.27e9, rel=1e-2)


def _published():
    with open(os.path.join(ROOT, "portbench", "configs", "granite-4.0-h-micro-bf16.json")) as f:
        return json.load(f)["model"]


def test_counts_at_the_published_widths():
    """The decode products' bound reads each of the program's AR matrices
    once a launch (its [out, in] shapes at the published widths, counted on
    the meta device), the attention's the 8 K/V heads' bytes for the 32
    query heads, and a decode step's operations are twice the products'
    weights plus the mixers' work (under 5% more)."""
    from vallex_tpu_torch.models.vallex import VALLE

    arch, model = load_arch(ROOT, "granite4h"), _published()
    with torch.device("meta"):
        prog = VALLE(arch.program_config(model))
    st = prog.ar_decoder  # the program's own matrices, [out, in]; Q, K, V fused as it packs them
    mats = ([m.in_proj.shape for m in st.mamba] + [m.out_proj.shape for m in st.mamba]
            + [(a.wq.shape[0] + a.wk.shape[0] + a.wv.shape[0], a.wq.shape[1]) for a in st.attn]
            + [a.wo.shape for a in st.attn] + [b.mlp_in.shape for b in st.layers]
            + [b.mlp_out.shape for b in st.layers] + [prog.ar_predict_layer.w.t().shape])
    assert len(mats) == 36 * 2 + 4 * 2 + 40 * 2 + 1
    weights = sum(o * i for o, i in mats)
    assert weights == pytest.approx(2.99e9, rel=1e-2)  # all but the 6.3 M of token tables
    bw = arch.PEAKS["hbm_bytes_per_s"]
    want = sum(2 * o * i + 4 * (o + i) for o, i in mats) / bw
    assert arch.gemm_small_m_bound_s(model, 2, [1], 1) == pytest.approx(want, rel=1e-9)
    assert arch.gemm_small_m_bound_s(model, 2, [1, 1, 0], 1) == pytest.approx(
        sum(2 * o * i + 8 * (o + i) for o, i in mats) / bw, rel=1e-9)
    keys = 100 + 161 + 2
    att = 4 * (2 * keys * 8 * 64 * 2 + 8 * 2048) / bw
    assert arch.masked_attention_bound_s(model, 2, [(100, 161, 5)], 1) == pytest.approx(att)
    assert arch.masked_attention_bound_s(model, 2, [(100, 161, 5)], 9) == pytest.approx(
        sum(4 * (2 * (keys + t) * 8 * 64 * 2 + 8 * 2048) / bw for t in range(5)))
    step = arch.ar_decode_flops(model, 100, 161, 1)
    assert 2 * weights < step < 1.05 * 2 * weights
    prefill = arch.ar_prefill_flops(model, 100, 161)
    assert 262 * 2 * (weights - 2048 * 1025) < prefill < 1.05 * 262 * 2 * weights
    vocos = _vocos()
    assert arch.request_flops(model, vocos, (100, 161, 5)) == (
        prefill + arch.ar_decode_flops(model, 100, 161, 5)
        + arch.nar_flops(model, 100, 161, 5) + arch.vocos_flops(vocos, 5))


def _vocos():
    with open(os.path.join(ROOT, "portbench", "configs", "granite-4.0-h-micro-bf16.json")) as f:
        return json.load(f)["vocos"]


def test_rooflines_and_mfu_read_the_architecture(tmp_path):
    """With the architecture's counts, the two decode rooflines and `mfu`
    read a number on a traced run of the cell (once a `benchmark` change
    lists the cell in their `workloads`)."""
    root = _tiny_root(tmp_path)
    cell = load_cell(CELL, root)
    kernels = [(0.0, 10.0, "void gemm_tc_kernel<48, 2>(float const*)"),
               (30.0, 40.0, "void masked_attention_split_kernel<__nv_bfloat16, 64>()")]
    recs = [Record(Batch(0, [], True, 0), 4.0, {}, 16, [(100, 161, 16)], 1.0),
            Record(Batch(1, [], True, 0), 9.0, {}, 16, [(100, 161, 10), (100, 161, 16)], 1.0,
                   True)]
    run = Run(cell, 1.0, None, recs, T.Trace(0.0, 100.0, kernels, []))
    for name in ("gemm_small_m_roofline", "masked_attention_roofline", "mfu"):
        v = load_reader(root, name)(run)
        assert v is not None and v > 0, name
