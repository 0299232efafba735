"""Smoke run of vallex_tpu_torch on one NVIDIA GPU (H100): builds the
hand-written kernels, holds each against its plain PyTorch version at full
width, then drives the port's entry points at the shipped width (random
weights from a seed) and shows that each path went through the kernels.

    python3 chip_smoke.py

Phases, one flushed line each with its own seconds and wall-clock limit:
  1  card name and power limit (nvidia-smi)
  2  kernel build (nvcc, from the sources in the checkout); the bf16 flash
     kernels' (forward, dQ, dK/dV) registers, shared memory and spills
     (ptxas; a spill fails) and their tensor-core instructions (HGMMA in the
     SASS, cuobjdump; none fails)
  3  each kernel against its plain version, at each single-request site
     (the NAR attention: the flash forward with the NAR's segments (ok, ok)
     at T = 2304); masked_attention at Tq = 16 (a verify pass at
     decode_steps = 16); the prep kernel of gemm_small_m (the LayerNorm
     rows of one verify pass); every product run twice, bitwise equal
  3b the same at the batched sites: decode attention with per-row bounds
     (B = 4), the NAR attention at B = 4, the products of one batched step
     at M = 4 and 8 (bf16 and int8, each row equal to its M = 1 product),
     sampling over 8 rows
  3c the same for best_of and filtered sampling: the filtered epilogue
     (top_k 10 / 50, top_p 0.9 / 0.5, 1 and 20 rows), the grouped decode
     attention (1 request x 5 samples, 4 x 5), the products at M = 16 and
     20, and the f32 products and attention (compute_dtype="float32")
  3f head dim 128 (d_model 1024, 8 heads, random weights from seed 0):
     the decode attention (draft step, verify pass, 16 queries, int8 K/V
     own column) and phase 3e's training attention against their plain
     versions; decode_block_fused and decode_verify against the CPU; one
     f32 and one bf16 train_step through the kernels and total_loss
     against the mask route; a greedy generate_audio (the hd-128 rows'
     launches are counted here)
  4  the ports of decode_block_fused (int8, K-1 = 7) and decode_verify
     (bf16, K = 8 and K = 16) against the same ops on the CPU (the plain
     versions)
  4b the batched decode_block_fused (K = 8, B = 4, bf16 and int8) against
     each row run alone from the same prefilled caches
  3d the same for the int8 KV cache, w8a8 and the single steps: the W8A8
     products (M = 1, 4, 8, 16, 20; cast-prologue products bitwise equal
     to the plain version; the W8A8 prep kernel's codes and scales), the
     int8 K/V attention in its own-column mode
     (single, batched B = 4, grouped 4 x 5) and the own-column mode over a
     bf16 cache (decode_attention, decode_step, decode_step_fused), the
     written column bitwise the plain version's; the products and the
     sampling of one decode_step
  4c the grouped decode_block_fused (4 requests x 5 samples, sampled)
     against the same 20 rows expanded at beams=1, fed the same uniforms
  4d the int8kv and w8a8 decode_block_fused (K = 8), decode_step and
     decode_step_fused (8 steps) and decode_attention (8 positions) against
     the same ops on the CPU (the plain versions)
  5  generate_audio twice (default sampled mode; top_k=1)
  6  generate_audio with s_text + t_audio >= 1536 (the NAR through the flash
     forward)
  5b generate_audio_batch of 4 requests: sampled, greedy, greedy int8; one
     single-request int8 generate_audio; greedy rows against single runs
  5c the HTTP server: 4 concurrent POST /synthesize coalesced by the
     DynamicBatcher into a batched call
  5d best_of, filtered sampling, long text, more than 8 rows, f32:
     generate_audio with best_of=5 and with top_k=50, top_p=0.9; the
     batch of 4 with best_of=5 (20 rows) and filtered; a greedy batch of
     16 against the batch of its first 4; long text in both modes; an f32
     greedy request through the kernels against the plain path on the CPU,
     also at decode_steps=16 (64 frames); bf16 requests at decode_steps=16;
     POST /synthesize-long and a best_of=2 POST; the CLI in a subprocess
  5e the int8 KV cache, w8a8, decode_steps=1 and decode_mode="pallas":
     generate_audio in w8a8 and int8kv (greedy, sampled; int8kv best_of=5);
     the batch of 4 in both modes, each greedy w8a8 row bitwise its request
     alone in w8a8; fixed-prompt long text in int8kv as one batch of 8
     sentences; a server with quantize="int8kv" answering 4 concurrent
     POSTs; the CLI with --quantize w8a8; decode_steps=1 greedy, sampled
     and filtered; decode_mode="pallas" greedy; f32 greedy requests with
     decode_steps=1 and with "pallas" against the CPU plain path
  3e the training attention (kernels/flash_attention.cu): the forward, dQ
     and dK/dV kernels against their plain versions at B = 4, H = 16,
     T = 1152 (text 128 + audio 1024), bf16 and f32, one padded segment
     per row and four packed ones, prefix T / 0 / 128; a ragged T = 1100
     (bf16 and f32, the same prefixes); bf16 q/k/v as views of a fused QKV
     with a transposed dO; two backward runs bitwise equal; the backward
     timed at prefix 128 and T
  5f training at the shipped width: train_step with AdamW on a fixed batch
     of four utterances for 10 steps (the loss falls), the kernel route
     against the mask route on that batch (loss, gradient cosine per
     leaf), a packed batch, two stage-1 ScaledAdam steps (the NAR
     parameters stay bitwise), one use_flash="auto" step, a profiled step
     (its bf16 backward must run on the tensor-core kernels alone)
  7  torch.profiler traces of one request and of one batch of 4: the
     device-busy share of their AR, NAR and Vocos spans, and the AR's
     device time by kernel and that of gemm_small_m's kernels
  8  the `kernels` JSON line, then the result line.
Launch counts are zeroed just before phase 5 and read after phase 6 (the
single-request path), zeroed again just before phase 5b and read after
phase 5c (the batched path), and once more just before phase 5d and read
after it (best_of and filtered sampling), and once more just before phase
5e and read after it (int8kv, w8a8, single steps, pallas), and once more
just before phase 5f and read after it (training). The NAR at C >= 1536
must launch the flash forward at its sites and masked_attention never
there. Any failure exits non-zero before the result line. No JAX is
imported.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave as wave_mod
from contextlib import contextmanager

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak (data sheet)
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores (data sheet)
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak (data sheet)

REPO = os.path.dirname(os.path.abspath(__file__))
TPU = {  # TPU kernel each main-path site stands for (file:line of the function)
    "decode_block_fused": "vallex_tpu/ops/decode_block.py:1329",
    "decode_verify": "vallex_tpu/ops/decode_verify.py:368",
    "flash_attention": "vallex_tpu/models/layers.py:205",
    # decode_block_fused(batched=True): its batched fold _hbm_fold_batched
    "decode_block_fused_batched": "vallex_tpu/ops/decode_block.py:828",
    "flash_attention_batched": "vallex_tpu/models/layers.py:205",
    # decode_block_fused(filtered=True): the top-k / top-p epilogue
    "decode_block_fused_filtered": "vallex_tpu/ops/decode_block.py:1259",
    # best_of: one request's samples (_hbm_fold_beams), R requests' (grouped)
    "decode_block_fused_beams": "vallex_tpu/ops/decode_block.py:638",
    "decode_block_fused_grouped": "vallex_tpu/ops/decode_block.py:1020",
    # decode_block_fused(act_quant=True) and decode_block_fused(kv_scales=...)
    "decode_block_fused_w8a8": "vallex_tpu/ops/decode_block.py:1329",
    "decode_block_fused_int8kv": "vallex_tpu/ops/decode_block.py:1329",
    "decode_step": "vallex_tpu/ops/decode_step.py:601",
    "decode_step_fused": "vallex_tpu/ops/decode_step.py:637",
    "decode_attention": "vallex_tpu/ops/decode_attention.py:181",
    # training: attention_core_flash_prefix (the AR's prefix-causal mask),
    # attention_core_flash with segment ids (the NAR, packed rows) and the
    # JAX library's flash backward (_flash_attention_bwd_dq / _dkv)
    "flash_attention_prefix": "vallex_tpu/models/layers.py:259",
    "flash_attention_train": "vallex_tpu/models/layers.py:205",
    "flash_attention_bwd": "vallex_tpu/models/layers.py:205",
}
# the same kernels at head dim 128 (phase 3f; their launches are counted there)
HD128 = "_hd128"
TPU.update({site + HD128: TPU[site] for site in (
    "decode_block_fused", "decode_verify", "flash_attention_prefix", "flash_attention_train",
    "flash_attention_bwd")})
BATCHED_SITES = ("decode_block_fused_batched", "flash_attention_batched")
SLICE3_SITES = ("decode_block_fused_filtered", "decode_block_fused_beams",
                "decode_block_fused_grouped")
SLICE4_SITES = ("decode_block_fused_w8a8", "decode_block_fused_int8kv", "decode_step",
                "decode_step_fused", "decode_attention")
SLICE5_SITES = ("flash_attention_prefix", "flash_attention_train", "flash_attention_bwd")
KERNEL_FILE = {"flash_attention_fwd": "flash_attention", "flash_attention_bwd_dq": "flash_attention",
               "flash_attention_bwd_dkv": "flash_attention", "gemm_small_m_prep": "gemm_small_m"}


def say(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str, limit_s: float):
    """Time a phase; a watchdog ends the process if it outlives its limit
    (a hung launch blocks in C, where no Python exception can reach)."""
    def expire():
        print(f"FAIL phase {name}: over its {limit_s:.0f} s limit", file=sys.stderr, flush=True)
        os._exit(124)

    timer = threading.Timer(limit_s, expire)
    timer.daemon = True
    timer.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timer.cancel()
    say(f"phase {name}: ok in {time.perf_counter() - t0:.2f} s")


def fail(msg: str) -> None:
    print("FAIL " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def busy_ms(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi), in
    ms (trace times are in µs)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e3


def trace_events(prof):
    """The events of a finished torch.profiler run, from its chrome trace."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def trace_run(label: str, run) -> None:
    """run() does one synthesis and returns (phase seconds, frames). Run it
    plainly (twice) and under torch.profiler, and report for each pipeline
    span the share of its wall time in which the card ran a kernel or a
    copy. Kernel times do not depend on the profiler; the host does more
    under it, so the share is also given against the unprofiled span's
    host-clock seconds."""
    from torch.profiler import ProfilerActivity, profile

    plain_s = {}
    for _ in range(2):  # the faster of two unprofiled runs
        secs, _ = run()
        for k, v in secs.items():
            plain_s[k] = min(v, plain_s.get(k, v))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, frames = run()
    events = trace_events(prof)
    spans = {e["name"][len("vallex."):]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("vallex.")}
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not device or "ar" not in spans:
        say(f"  trace: not measured ({len(device)} device events, spans {sorted(spans)})")
        return
    out = {"request": f"{label}, {frames} frames"}
    for name, (lo, hi) in sorted(spans.items()):
        inside = [(a, b) for a, b, _ in device if b > lo and a < hi]
        busy = busy_ms(inside, lo, hi)
        wall = (hi - lo) / 1e3
        row = {"wall_ms_traced": round(wall, 3), "device_busy_ms": round(busy, 3),
               "busy_share_traced": round(busy / wall, 4), "device_ops": len(inside)}
        if name in plain_s:
            row["wall_ms_untraced"] = round(plain_s[name] * 1e3, 3)
            row["busy_share_untraced"] = round(busy / (plain_s[name] * 1e3), 4)
        out[name] = row
    lo, hi = spans["ar"]
    by_name = {}
    for a, b, n in device:
        if b > lo and a < hi:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
    out["ar_device_ms_by_kernel"] = {n[:80]: round(t, 3) for n, t in
                                     sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    # every kernel of gemm_small_m (its prep, products and f32 kind); with
    # programmatic dependent launch a product's span includes its wait
    gemm = {n: t for n, t in by_name.items() if n.replace("void ", "").startswith("gemm_")}
    out["ar_gemm_small_m_device_ms"] = round(sum(gemm.values()), 3)
    out["ar_gemm_small_m_busy_ms"] = round(busy_ms(
        [(a, b) for a, b, n in device if b > lo and a < hi and n in gemm], lo, hi), 3)
    say("trace " + json.dumps(out))


def running_max_rounding(q, k, v, seg, prefix):
    """The bf16 flash forward's rounding order in plain PyTorch, f32: key
    tiles of 64 in order, each p rounded to bf16 at the running row max (as
    the kernel and the JAX library's kernel round it), where the plain
    version rounds at the final max. A diagnostic of the NAR check."""
    import torch

    from vallex_tpu_torch.kernels.flash_attention import valid_pairs

    B, H, T, hd = q.shape
    ok = valid_pairs(seg, seg, prefix)[:, None]
    qf = q.float() * (hd ** -0.5 * 1.4426950408889634)  # scores in log2 units
    m = torch.full((B, H, T, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, T, hd), device=q.device)
    for k0 in range(0, T, 64):
        s = (qf @ k[:, :, k0:k0 + 64].float().transpose(-1, -2))
        s = s.masked_fill(~ok[..., k0:k0 + 64], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha, p = torch.exp2(m - base), torch.exp2(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ v[:, :, k0:k0 + 64].float()
        m = m_new
    return acc / torch.where(l > 0, l, torch.ones_like(l))


TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")


def tc_kernel_report(lib) -> None:
    """Phase 2's report on the build: each kernel's ptxas line; for the bf16
    flash kernels (tensor cores) their registers, shared memory, spills and
    any serialized wgmma ptxas reports, their dynamic shared memory per
    block, and their HGMMA count in the SASS (cuobjdump). Fails if one of
    them has no HGMMA instruction or ptxas reports a spill."""
    from vallex_tpu_torch.kernels import loader

    report = lib.parent / ("ptxas_" + lib.name.split("_")[-1].split(".")[0] + ".txt")
    if report.exists():
        text = report.read_text()
        for line in text.splitlines():
            if "Used" in line and "registers" in line:
                say("  ptxas: " + line.split("ptxas info    :")[-1].strip())
        for blk in text.split("Compiling entry function")[1:]:
            name = [k for k in TC_KERNELS if k in blk.split("\n")[0]]
            if name:
                said = [ln.split(":", 1)[-1].strip() for ln in blk.splitlines()[1:]
                        if any(w in ln for w in ("stack frame", "Used", "wgmma", "smem"))]
                say(f"  ptxas {name[0]}: " + "; ".join(said))
                spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", blk)
                if any(int(x) for x in spills):
                    fail(f"{name[0]}: ptxas reports spills: {'; '.join(said)}")
    lib_ = loader.library()
    say("  dynamic shared memory per block at T = 2304: flash_fwd_tc_kernel"
        f" {lib_.vx_flash_attention_fwd_smem(2304)}, flash_bwd_dq_tc_kernel"
        f" {lib_.vx_flash_attention_bwd_smem(2304, 0)}, flash_bwd_dkv_tc_kernel"
        f" {lib_.vx_flash_attention_bwd_smem(2304, 1)} bytes")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        say("  SASS: no cuobjdump in this toolkit; tensor-core instructions not counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    per_fn, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            per_fn[fn] = [0, 0]
        elif fn is not None:
            per_fn[fn][0] += "HGMMA" in line
            per_fn[fn][1] += bool(re.search(r"\bHMMA", line))
    for kernel in TC_KERNELS:
        tc = [c for f, c in per_fn.items() if kernel in f]
        if not tc or tc[0][0] == 0:
            fail(f"{kernel}: no HGMMA instruction in its SASS ({tc})")
        say(f"  SASS (cuobjdump -sass): {kernel} holds {tc[0][0]} HGMMA and {tc[0][1]} HMMA"
            " instructions")


# ---------------------------------------------------------------------------
# Training (phases 3e and 5f): module-level so each phase reads only what it
# is handed.
# ---------------------------------------------------------------------------

TRAIN_TEXT, TRAIN_AUDIO = [60, 90, 110, 128], [400, 650, 800, 1000]


def train_segments(layout: str, B: int, T: int, s_text: int, dev):
    """[B, T] int32 segment ids over a [text (s_text) | audio] row: "padded"
    holds one utterance per row (text TRAIN_TEXT[b], audio TRAIN_AUDIO[b]
    + 1 with the BOS, as ar_loss lays them out; cut at T), "packed" four
    utterances per row back to back in each region."""
    import torch

    seg = torch.zeros((B, T), dtype=torch.int32)
    for b in range(B):
        if layout == "padded":
            seg[b, :TRAIN_TEXT[b % 4]] = 1
            seg[b, s_text: s_text + TRAIN_AUDIO[b % 4] + 1] = 1
        else:
            t_cut = [0, 30 + b, 60, 95 - b, s_text]
            a_cut = [s_text, s_text + 250 + 10 * b, s_text + 500, s_text + 760 - 5 * b,
                     s_text + 1000]
            for u in range(4):
                seg[b, t_cut[u]: t_cut[u + 1]] = u + 1
                seg[b, a_cut[u]: a_cut[u + 1]] = u + 1
    return seg.to(dev)


def utterances(seed, lens_t, lens_a):
    """Random utterances (text ids, 8 codebooks of audio) as the dataset yields them."""
    import numpy as np

    r = np.random.RandomState(seed)
    return [dict(utt_id=f"u{i}", text_tokens=r.randint(5, 99, (t,)), text_tokens_lens=t,
                 language=0, audio_features=r.randint(0, 1024, (8, a)),
                 audio_features_lens=a)
            for i, (t, a) in enumerate(zip(lens_t, lens_a))]


def train_kernel_checks(dev, entry, device_ms, g, H=16, hd=64, suffix="") -> None:
    """Phase 3e: the flash forward, dQ and dK/dV kernels against their plain
    versions at the training shapes (B = 4, H = 16, T = 1152 = text 128 +
    audio 1024, hd 64), bf16 and f32, one padded segment per row and four
    packed ones, prefix P = T (key padding, the NAR), 0 (causal) and 128
    (the AR's prefix-causal mask); a ragged T = 1100 (text 128 + audio 972,
    not a multiple of the kernels' 64-row tiles) at the same prefixes; bf16
    q/k/v as the strided views of a fused [B, T, 3 H 64] QKV product (as the
    training layers pass them) with dO a transposed view; two backward runs
    bitwise equal in every case. Times the backward at P = 128 (rows y, z)
    and at P = T (rows yT, zT) against SDPA's whole backward. H and hd: the
    same at head dim 128 (H = 8; bf16 then runs the CUDA-core kernels), its
    rows at the sites + suffix."""
    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
        flash_attention_fwd, flash_attention_plain, valid_pairs,
    )

    B, S = 4, 128

    def inputs(dt, T, fused):
        """q, k, v, dO [B, H, T, hd]: contiguous, or (fused) q/k/v as views
        of one [B, T, 3 H hd] product and dO the transpose of [B, T, H, hd]."""
        if not fused:
            return [torch.randn((B, H, T, hd), generator=g, device=dev).to(dt) for _ in range(4)]
        qkv = torch.randn((B, T, 3 * H * hd), generator=g, device=dev).to(dt)
        q, k, v = (t.view(B, T, H, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        do = torch.randn((B, T, H, hd), generator=g, device=dev).to(dt).transpose(1, 2)
        return q, k, v, do

    cases = [(dt, layout, 1152, P, False) for dt in (torch.bfloat16, torch.float32)
             for layout in ("padded", "packed") for P in (1152, 0, S)]
    cases += [(dt, "padded", 1100, P, False) for dt in (torch.bfloat16, torch.float32)
              for P in (1100, 0, S)]
    cases += [(torch.bfloat16, "padded", T, P, True) for T in (1152, 1100) for P in (T, S)]
    for dt, layout, T, P, fused in cases:
        bf = dt == torch.bfloat16
        seg = train_segments(layout, B, T, S, dev)
        q, k, v, do = inputs(dt, T, fused)
        o, lse = flash_attention_fwd(q, k, v, seg, seg, P, site="check")
        op, lp = flash_attention_plain(q, k, v, seg, seg, P)
        grads = flash_attention_bwd(q, k, v, seg, seg, P, o, lse, do)
        again = flash_attention_bwd(q, k, v, seg, seg, P, o, lse, do)
        ref = flash_attention_bwd_plain(q, k, v, seg, seg, P, o, lse, do)
        torch.cuda.synchronize()
        case = (f"{str(dt)[6:]} {layout} T={T} P={P}"
                + (" fused-QKV views, transposed dO" if fused else ""))
        err_o = float((o.float() - op.float()).abs().max())
        scale_o = float(op.float().abs().max())
        err_l = float((lse - lp).abs().max())
        if not (err_o <= (1e-2 if bf else 2e-5) * scale_o and err_l <= 1e-3):
            fail(f"flash_attention_fwd {case}: out err {err_o} of scale {scale_o},"
                 f" lse err {err_l}")
        rel, err = [], []
        for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
            e, sc = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
            rel.append(e / sc)
            err.append(e)
            if not e <= (2e-2 if bf else 1e-4) * sc:
                fail(f"flash_attention_bwd {case}: {name} err {e} of scale {sc}")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"flash_attention_bwd {case}: two runs differ")
        say(f"  flash_attention {case}: out err {err_o:.3e} (scale {scale_o:.3f}), lse err"
            f" {err_l:.3e}, dq/dk/dv err {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e} of their"
            f" scale, two backward runs bitwise equal")
        # timed: the padded layout at the main path's prefixes (P = T: the
        # NAR's key padding, forward and backward; P = 128: the AR's
        # prefix-causal attention and its backward), the packed one at P = 128
        if fused or T != 1152 or not (P == S or (P == T and layout == "padded")):
            continue
        pairs = int(valid_pairs(seg, seg, P).sum()) * H
        es, n = q.element_size(), B * H * T * hd
        seg_bytes, row_bytes = 2 * B * T * 4, B * H * T * 4
        rate = BF16_OPS_PER_S if bf else F32_OPS_PER_S
        in_line = bf and layout == "padded"
        what = (f"B={B}, H={H}, hd={hd}, T={T}, {str(dt)[6:]}, {layout}, prefix {P},"
                f" {pairs} valid pairs")
        mask = valid_pairs(seg, seg, P)[:, None]
        lib_fwd = device_ms(lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        entry("flash_attention_fwd",
              ("flash_attention_prefix" if P == S else "flash_attention_train") + suffix, err_o,
              device_ms(lambda: flash_attention_fwd(q, k, v, seg, seg, P)),
              device_ms(lambda: flash_attention_plain(q, k, v, seg, seg, P)),
              4 * n * es + row_bytes + seg_bytes, 4 * hd * pairs, lib_fwd,
              f"1 launch: {what}", in_line, rate)
        # the backward at P = 128 in both layouts (rows y, z) and, bf16
        # only, at P = T (rows yT, zT: the NAR's training backward; printed
        # beside the site's row)
        if P != S and not bf:
            continue
        in_line = in_line and P == S
        row = "" if P == S else " (rows yT, zT)"
        qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lib_bwd = device_ms(lambda: torch.autograd.grad(
            Fn.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask), (qr, kr, vr),
            do)) - lib_fwd
        dq, di = flash_attention_bwd_dq(q, k, v, seg, seg, P, o, lse, do)
        entry("flash_attention_bwd_dq", "flash_attention_bwd" + suffix, err[0],
              device_ms(lambda: flash_attention_bwd_dq(q, k, v, seg, seg, P, o, lse, do)),
              device_ms(lambda: flash_attention_bwd_dq_plain(q, k, v, seg, seg, P, o, lse,
                                                             do)),
              6 * n * es + 2 * row_bytes + seg_bytes, 6 * hd * pairs, lib_bwd,
              f"1 launch: dq and di, {what}; library: SDPA's whole backward{row}", in_line,
              rate)
        entry("flash_attention_bwd_dkv", "flash_attention_bwd" + suffix, max(err[1:]),
              device_ms(lambda: flash_attention_bwd_dkv(q, k, v, seg, seg, P, do, lse, di)),
              device_ms(lambda: flash_attention_bwd_dkv_plain(q, k, v, seg, seg, P, o, lse,
                                                              do)),
              6 * n * es + 2 * row_bytes + seg_bytes, 8 * hd * pairs, lib_bwd,
              f"1 launch: dk and dv, {what}; library: SDPA's whole backward{row}", in_line,
              rate)
        del qr, kr, vr, mask


def train_head_dim(dev, cfg) -> None:
    """Phase 3f's training half at cfg's head dim: one train_step in f32 and
    one in bf16 through the flash kernels, then total_loss through the
    kernels against the mask route in f32 (loss, gradient cosine per leaf,
    held as phase 5f holds them)."""
    import numpy as np
    import torch

    from vallex_tpu_torch.convert import load_tree
    from vallex_tpu_torch.data.dataset import collate
    from vallex_tpu_torch.models.vallex import VALLE, init_vallex
    from vallex_tpu_torch.train import loss as TLoss
    from vallex_tpu_torch.train import step as TStep
    from vallex_tpu_torch.train.trainer import to_device

    model = load_tree(VALLE(cfg), init_vallex(cfg, torch.Generator().manual_seed(0)),
                      dtype=torch.float32, device=dev)
    batch = to_device(collate(utterances(0, TRAIN_TEXT, TRAIN_AUDIO)), dev)
    opt = TStep.make_optimizer(base_lr=1e-4)
    state = TStep.init_train_state(model, opt)
    losses = {}
    for dt in ("float32", "bfloat16"):
        state, met = TStep.train_step(state, batch, torch.Generator().manual_seed(42), cfg=cfg,
                                      optimizer=opt, dtype=dt, use_flash=True)
        losses[dt] = float(met["loss"])
    if not np.isfinite(list(losses.values())).all():
        fail(f"3f train_step at head dim {cfg.head_dim}: losses {losses}")

    def loss_and_grads(use_flash):
        model.zero_grad(set_to_none=True)
        loss, _ = TLoss.total_loss(model, cfg, batch, torch.Generator().manual_seed(7),
                                   torch.float32, 1, use_flash)
        loss.backward()
        return float(loss.detach()), [torch.cat([p.grad.float().flatten() for p in leaf.params])
                                      for leaf in state.leaves]

    (lk, gk), (lm, gm) = loss_and_grads(True), loss_and_grads(False)
    cos = []
    for a, b in zip(gk, gm):
        na, nb = float(a.norm()), float(b.norm())
        cos.append(1.0 if na == nb == 0 else float(a @ b) / max(na * nb, 1e-30))
    if not (abs(lk - lm) <= 1e-2 * abs(lm) and min(cos) >= 0.999):
        fail(f"3f kernels vs mask route at head dim {cfg.head_dim}: loss {lk} vs {lm},"
             f" gradient cosine {min(cos)}")
    say(f"  train_step at head dim {cfg.head_dim} (flash, batch of 4): loss f32 {losses['float32']:.4f},"
        f" bf16 {losses['bfloat16']:.4f}; total_loss through the kernels vs the mask route, f32:"
        f" loss {lk:.5f} vs {lm:.5f}, gradient cosine >= {min(cos):.6f} over {len(cos)} leaves")
    del model, state, opt, batch
    torch.cuda.empty_cache()


def train_path(dev, cfg) -> None:
    """Phase 5f: the training slice at the shipped width (random weights
    from seed 0, f32 parameters, bf16 compute, remat): train_step with
    AdamW on a fixed batch of four utterances, the kernel route against the
    mask route on the same batch, a packed batch, two stage-1 ScaledAdam
    steps, and one use_flash="auto" step; a profile of one step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vallex_tpu_torch.convert import load_tree
    from vallex_tpu_torch.data.dataset import collate, collate_packed
    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.models.vallex import VALLE, init_vallex, stage_param_labels
    from vallex_tpu_torch.train import loss as TLoss
    from vallex_tpu_torch.train import step as TStep
    from vallex_tpu_torch.train.scaled_adam import eden_schedule, scaled_adam
    from vallex_tpu_torch.train.trainer import to_device

    model = load_tree(VALLE(cfg), init_vallex(cfg, torch.Generator().manual_seed(0)),
                      dtype=torch.float32, device=dev)
    batch = to_device(collate(utterances(0, TRAIN_TEXT, TRAIN_AUDIO)), dev)
    frames = sum(TRAIN_AUDIO)
    opt = TStep.make_optimizer(base_lr=1e-4)
    state = TStep.init_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()

    def step(st, b, optimizer, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = TStep.train_step(st, b, torch.Generator().manual_seed(42), cfg=cfg,
                                   optimizer=optimizer, dtype="bfloat16", **kw)
        out = {k: float(v) for k, v in met.items()}
        return st, out, time.perf_counter() - t0

    losses, secs = [], []
    for _ in range(10):
        state, met, s = step(state, batch, opt, use_flash=True)
        losses.append(met["loss"])
        secs.append(s)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"5f train_step AdamW: losses {losses}")
    sps = statistics.median(secs[1:])
    say(f"  train_step AdamW (base_lr 1e-4, flash), batch of 4 (text {TRAIN_TEXT}, audio"
        f" {TRAIN_AUDIO} frames; S=128, T=1024): loss {losses[0]:.4f} -> {losses[-1]:.4f} in 10"
        f" steps; {sps:.4f} s/step (median of steps 1-9; step 0 {secs[0]:.2f} s),"
        f" {frames / sps:.1f} audio frames/s, grad_norm {met['grad_norm']:.3f},"
        f" max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel route against the mask route: same batch, same draws. The
    # gradients are held in f32 compute; in bf16 the two routes round at
    # different places (the mask route's autograd rounds dP, the kernels
    # round p and ds, as the JAX library's kernels do), so there each is
    # printed against the f32 kernel route's gradients.
    leaves = state.leaves

    def loss_and_grads(use_flash, dtype):
        model.zero_grad(set_to_none=True)
        loss, _ = TLoss.total_loss(model, cfg, batch, torch.Generator().manual_seed(7), dtype,
                                   1, use_flash)
        loss.backward()
        return float(loss.detach()), [
            torch.cat([p.grad.float().flatten() for p in leaf.params]) for leaf in leaves]

    def cosines(ga, gb):
        out = []
        for a, b in zip(ga, gb):
            na, nb = float(a.norm()), float(b.norm())
            out.append(1.0 if na == nb == 0 else float(a @ b) / max(na * nb, 1e-30))
        return out

    res = {(fl, dt): loss_and_grads(fl, dt) for fl in (True, False)
           for dt in (torch.float32, torch.bfloat16)}
    (l32, g32), (lm32, gm32) = res[(True, torch.float32)], res[(False, torch.float32)]
    (lbf, gbf), (lmbf, gmbf) = res[(True, torch.bfloat16)], res[(False, torch.bfloat16)]
    cos = cosines(g32, gm32)
    worst = int(np.argmin(cos))
    if not (abs(l32 - lm32) <= 1e-2 * abs(lm32) and abs(lbf - lmbf) <= 1e-2 * abs(lmbf)
            and min(cos) >= 0.999):
        fail(f"5f kernels vs mask route: f32 loss {l32} vs {lm32}, bf16 loss {lbf} vs {lmbf},"
             f" worst f32 gradient cosine {cos[worst]} ({leaves[worst].name})")
    say(f"  total_loss through the kernels vs the mask route, f32: loss {l32:.5f} vs"
        f" {lm32:.5f}, gradient cosine >= {min(cos):.6f} over {len(cos)} leaves (lowest:"
        f" {leaves[worst].name})")
    for name, g_ in (("kernel route", gbf), ("mask route", gmbf)):
        c = cosines(g_, g32)
        w = int(np.argmin(c))
        say(f"    bf16 {name} against the f32 kernel route's gradients: cosine >= {c[w]:.6f}"
            f" ({leaves[w].name}), median {statistics.median(c):.6f}")
    c = cosines(gbf, gmbf)
    w = int(np.argmin(c))
    say(f"    bf16: loss {lbf:.5f} (kernels) vs {lmbf:.5f} (mask), gradient cosine between the two"
        f" routes >= {c[w]:.6f} ({leaves[w].name})")
    del res, g32, gm32, gbf, gmbf
    model.zero_grad(set_to_none=True)

    # a packed batch: 8 utterances, 2 per row
    p_audio = [150, 300, 420, 500, 250, 350, 480, 200]
    pb = to_device(collate_packed(utterances(1, [20, 35, 50, 64, 30, 45, 60, 40], p_audio),
                                  pack=2), dev)
    pl = []
    for _ in range(3):
        state, met, s = step(state, pb, opt, packed=True)
        pl.append(met["loss"])
    if not np.isfinite(pl).all():
        fail(f"5f packed: losses {pl}")
    say(f"  packed batch (8 utterances, pack=2, rows {tuple(pb['p_audio_in'].shape)}): losses"
        f" {[round(x, 4) for x in pl]}, {s:.4f} s/step, {sum(p_audio) / s:.1f} audio frames/s")

    # stage 1 with ScaledAdam: the NAR parameters must not move
    labels = stage_param_labels(model, 1)
    by_id = {id(p): labels[n] for n, p in model.named_parameters()}
    sa = TStep.Masked(scaled_adam(eden_schedule(0.05)),
                      [by_id[id(leaf.params[0])] for leaf in leaves])
    st1 = TStep.TrainState(model, leaves, sa.init(leaves), 0)
    nar = {n: p.detach().clone() for n, p in model.named_parameters() if not labels[n]}
    ar0 = model.ar_text_embedding.weight.detach().clone()
    for _ in range(2):
        st1, met, s = step(st1, batch, sa, use_flash=True)
    moved = [n for n, p in model.named_parameters() if n in nar and not torch.equal(p, nar[n])]
    if moved or torch.equal(ar0, model.ar_text_embedding.weight) or not np.isfinite(met["loss"]):
        fail(f"5f stage 1 ScaledAdam: NAR parameters moved {moved[:3]}, loss {met['loss']}")
    say(f"  --train-stage 1 ScaledAdam, 2 steps: loss {met['loss']:.4f}, {len(nar)} NAR"
        f" parameters bitwise unchanged, the AR ones moved")
    del nar, st1, sa

    # use_flash="auto" on a batch of >= 800 frames takes the kernels
    before = sum(n for (kname, _), n in loader.launch_counts.items()
                 if kname.startswith("flash_attention"))
    state, met, s = step(state, batch, opt, use_flash="auto")
    after = sum(n for (kname, _), n in loader.launch_counts.items()
                if kname.startswith("flash_attention"))
    if after <= before:
        fail("5f use_flash='auto' at T=1024: no flash kernel launched")
    say(f"  use_flash='auto', T=1024 frames: the kernels ({after - before} launches in the step:"
        f" forward, its re-run under remat, dQ and dK/dV for 2 x {cfg.num_layers} layers),"
        f" loss {met['loss']:.4f}, {s:.4f} s")

    # one profiled step: device time by kernel and the device-busy share; the
    # bf16 backward must run on the tensor-core kernels alone
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, met, s = step(state, batch, opt, use_flash=True)
    events = trace_events(prof)
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not device:
        fail("5f trace of one train_step: no device events")
    lo, hi = min(a for a, _, _ in device), max(b for _, b, _ in device)
    by_name = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    flash = {n.split("(")[0].replace("void ", ""): round(t, 3) for n, t in by_name.items()
             if "flash_" in n}
    cuda_core_bwd = [n for n in flash if n.startswith(("flash_bwd_dq_kernel",
                                                       "flash_bwd_dkv_kernel"))]
    if cuda_core_bwd or not all(k in flash for k in TC_KERNELS):
        fail(f"5f trace of a bf16 train_step: flash kernels {flash}; want {TC_KERNELS} and no"
             " CUDA-core backward")
    top = {n[:80]: round(t, 3) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    by_class = {}
    for name, t in by_name.items():
        low = name.lower()
        cls = ("flash_attention" if low.startswith(("void flash_", "flash_")) else
               "matmul" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")) else
               "other")
        by_class[cls] = round(by_class.get(cls, 0.0) + t, 3)
    say("trace " + json.dumps({
        "request": "train_step, batch of 4 (T=1024), flash, bf16, AdamW",
        "wall_ms_traced": round(s * 1e3, 3),
        "device_busy_ms": round(busy_ms([(a, b) for a, b, _ in device], lo, hi), 3),
        "device_window_ms": round((hi - lo) / 1e3, 3), "device_ops": len(device),
        "device_ms_by_class": by_class, "flash_device_ms_by_kernel": flash,
        "device_ms_by_kernel": top}))
    del state, model, opt, batch, pb
    torch.cuda.empty_cache()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the GPU")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as Fn

    from vallex_tpu_torch import api
    from vallex_tpu_torch.engine import ar as AR
    from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
    from vallex_tpu_torch.kernels import (
        gemm_small_m, gemm_small_m_plain, loader, masked_attention,
        masked_attention_plain, sample_epilogue, sample_epilogue_plain,
    )
    from vallex_tpu_torch.kernels.gemm_small_m import gemm_prep, gemm_prep_plain
    from vallex_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain, valid_pairs,
    )
    from vallex_tpu_torch.kernels.masked_attention import (
        attention_bounds, valid_keys, with_prefix, write_column,
    )
    from vallex_tpu_torch.ops.decode_attention import decode_attention
    from vallex_tpu_torch.ops.decode_block import decode_block_fused
    from vallex_tpu_torch.ops.decode_step import decode_step, decode_step_fused, pack_layer_weights
    from vallex_tpu_torch.ops.decode_verify import decode_verify, embed
    from vallex_tpu_torch.ops.sampling import topk_keep_mask
    from vallex_tpu_torch.server import DynamicBatcher, make_server

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("1 card", 60):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        say(smi.splitlines()[0])
        say(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    with phase("2 build", 300):
        t0 = time.perf_counter()
        lib = loader.build()
        say(f"built {os.path.relpath(lib, REPO)} in {time.perf_counter() - t0:.2f} s")
        tc_kernel_report(lib)
        loader.library()

    # ---- shared full-width state --------------------------------------------
    bundle = api.preload_models(random_weights=True, seed=0, device=dev)
    cfg = bundle.cfg
    NL, H, hd, D, F = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.ffn_dim
    vocab, eos = cfg.num_audio_tokens + 1, cfg.eos_id
    packed, draft = bundle.pipeline.packed_weights(True)
    VP = packed["wpred"].shape[0]
    g = torch.Generator(device=dev).manual_seed(1)
    # a paimon-prompted "Hello world." (phase 5): the cache the main path
    # decodes over, C = s_text + t_audio + K slack rows
    S_TEXT, X_LEN, POS0, T_AUDIO = 128, 50, 600, 2048
    C = S_TEXT + T_AUDIO + 8
    cache_k = (torch.randn((NL, H, C, hd), generator=g, device=dev)).to(torch.bfloat16)
    cache_v = (torch.randn((NL, H, C, hd), generator=g, device=dev)).to(torch.bfloat16)
    # four batched requests (phases 3b, 4b): their own text and prompt
    # lengths; the prompt bucket is the 758-frame fuxuan prompt's (ABLK-rounded)
    XL_B, PL_B, T_GEN = [20, 52, 90, 128], [0, 60, 400, 758], 2048
    P_AUDIO = -(-(max(PL_B) + 1) // AR.ABLK) * AR.ABLK
    C_B = S_TEXT + P_AUDIO + T_GEN + 8

    has_sleep = hasattr(torch.cuda, "_sleep")

    def device_ms(fn, reps=20):
        """Median device time of fn over reps, by CUDA events. A spin
        kernel queued first keeps the card busy while the host enqueues,
        so host launch overhead stays out of the interval."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if has_sleep:
                torch.cuda._sleep(20_000_000)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    entries = []

    def entry(kernel, site, err, ms, plain_ms, bytes_, ops, library_ms, unit, in_line=True,
              ops_per_s=BF16_OPS_PER_S):
        """One measured row; rows with in_line=False are variants printed
        beside their site's row but kept out of the `kernels` line, which
        has one entry per (kernel, site) launch counter."""
        bound_b, bound_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
        if in_line:
            entries.append(dict(
                name=f"{kernel}@{site}", route="cuda",
                source=f"vallex_tpu_torch/kernels/{KERNEL_FILE.get(kernel, kernel)}.cu",
                replaces=TPU[site],
                launches=0, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_b, bound_o),
                bound_by="bytes" if bound_b >= bound_o else "operations",
                library_ms=library_ms, unit=unit))
        say(f"  {kernel}@{site}: max_abs_err {err:.3e}  {ms:.4f} ms  plain {plain_ms:.4f} ms"
            f"  bound {max(bound_b, bound_o):.4f} ms  library "
            f"{'null' if library_ms is None else f'{library_ms:.4f} ms'}  ({unit})")

    # ---- kernel checks -------------------------------------------------------
    def gemm_calls(lw, M, act_quant=False):
        """The 49 products of one decode step at M rows; act_quant: the 48
        layer products W8A8, the head W8A16 (as the TPU kernels)."""
        x_d = torch.randn((M, D), generator=g, device=dev)
        x_f = torch.relu(torch.randn((M, F), generator=g, device=dev))
        aq = dict(act_quant=True) if act_quant else {}
        calls = []
        for li in range(NL):
            sc = (lambda n: None if lw[n] is None else lw[n][li])
            calls += [
                (x_d, lw["wqkv"][li], dict(scale=sc("sqkv"), bias=lw["bqkv"][li],
                                           ln=(lw["ln1s"][li], lw["ln1b"][li]), **aq)),
                (x_d, lw["wout"][li], dict(scale=sc("sout"), bias=lw["bout"][li], residual=x_d,
                                           **aq)),
                (x_d, lw["w1"][li], dict(scale=sc("s1"), bias=lw["b1"][li],
                                         ln=(lw["ln2s"][li], lw["ln2b"][li]), relu=True, **aq)),
                (x_f, lw["w2"][li], dict(scale=sc("s2"), bias=lw["b2"][li], residual=x_d, **aq)),
            ]
        calls.append((x_d, lw["wpred"], dict(scale=lw["spred"], ln=(lw["fns"], lw["fnb"]))))
        return calls

    def int8_library_ms(calls):
        """torch._weight_int8pack_mm (bf16 x, int8 W [N, K], bf16
        scales) per product, or None where this torch has no CUDA
        kernel for it or its result is not the same product."""
        xs = [(x.to(torch.bfloat16).contiguous(), w, kw["scale"].to(torch.bfloat16))
              for x, w, kw in calls]
        try:
            y = torch._weight_int8pack_mm(*xs[-1])
        except (AttributeError, NotImplementedError, RuntimeError) as exc:
            say(f"  library: torch._weight_int8pack_mm unavailable on CUDA: {str(exc).splitlines()[0][:160]}")
            return None
        x, w, sc = xs[-1]
        ref = gemm_small_m_plain(x, w, scale=sc)
        e = float((y.float() - ref).abs().max())
        say(f"  library: torch._weight_int8pack_mm head product max_abs_err {e:.3e}"
            f" vs the plain version (scale {float(ref.abs().max()):.2f})")
        if not e <= 2e-2 * max(1.0, float(ref.abs().max())):
            say("  library: torch._weight_int8pack_mm computes another product; not timed")
            return None
        return device_ms(lambda: [torch._weight_int8pack_mm(x, w, sc) for x, w, sc in xs])

    def int_mm_library_ms(calls, M):
        """torch._int_mm (int8 x int8 → int32, the integer product alone)
        per W8A8 product, the rows padded to 17: on CUDA it refuses 16 rows
        or fewer. None where this torch has no such kernel."""
        rows = max(M, 17)
        xs = [(torch.randint(-127, 128, (rows, w.shape[1]), generator=g, device=dev,
                             dtype=torch.int8), w.t()) for _, w, kw in calls if kw.get("act_quant")]
        try:
            torch._int_mm(*xs[0])
        except (AttributeError, NotImplementedError, RuntimeError) as exc:
            say(f"  library: torch._int_mm unavailable on CUDA: {str(exc).splitlines()[0][:160]}")
            return None
        say(f"  library: torch._int_mm on {rows} rows (M={M} padded to at least 17), the int32"
            f" products of the {len(xs)} W8A8 layer products only")
        return device_ms(lambda: [torch._int_mm(a, b) for a, b in xs])

    def check_gemm(site, lw, M, unit, in_line=True, act_quant=False):
        calls = gemm_calls(lw, M, act_quant)
        f32 = lw["wqkv"].dtype == torch.float32
        err = 0.0
        for x, w, kw in calls:
            yk = gemm_small_m(x, w, site="check", **kw)
            again = gemm_small_m(x, w, site="check", **kw)
            yp = gemm_small_m_plain(x, w, **kw)
            torch.cuda.synchronize()
            if not torch.equal(yk, again):
                # fixed-order sums, no atomics (gemm_small_m.cu)
                fail(f"gemm_small_m@{site}: two runs differ for w {tuple(w.shape)}, M={M}")
            scale = max(1.0, float(yp.abs().max()))
            e = float((yk - yp).abs().max())
            # activations are rounded to bf16 (int8 with act_quant) after an
            # f32 LayerNorm on both sides; one rounding flip moves a sum by
            # ~1e-3 of its scale. f32 weights: no rounding, only the order of
            # the f32 sums
            if not e <= (1e-4 if f32 else 1e-2) * scale:
                fail(f"gemm_small_m@{site}: err {e} at scale {scale} for w {tuple(w.shape)}")
            if kw.get("act_quant") and "ln" not in kw and not torch.equal(yk, yp):
                # a cast prologue: the same int8 codes, an exact integer sum
                # and the same rounded epilogue on both sides
                fail(f"gemm_small_m@{site}: W8A8 product with a cast prologue differs from"
                     f" the plain version by {e} for w {tuple(w.shape)}")
            err = max(err, e)
            if M > 1:
                # a request's output must not depend on its companions: each
                # row reduces in the same order at any M (gemm_small_m.cu)
                for m in range(M):
                    one = gemm_small_m(x[m:m + 1], w, site="check", **{
                        k: (v[m:m + 1] if k == "residual" else v) for k, v in kw.items()})
                    if not torch.equal(one[0], yk[m]):
                        fail(f"gemm_small_m@{site}: row {m} of M={M} differs from its M=1 product")
        yk, yp = gemm_small_m(*calls[-1][:2], site="check", **calls[-1][2]), \
            gemm_small_m_plain(*calls[-1][:2], **calls[-1][2])
        if not torch.equal(yk[:, :vocab].argmax(-1), yp[:, :vocab].argmax(-1)):
            fail(f"gemm_small_m@{site}: head argmax disagrees")
        ms = device_ms(lambda: [gemm_small_m(x, w, site="check", **kw) for x, w, kw in calls])
        pms = device_ms(lambda: [gemm_small_m_plain(x, w, **kw) for x, w, kw in calls])
        if act_quant and M == 1:
            # where a W8A8 step's time goes: each product of layer 0 in W8A8
            # and in W8A16 (the same int8 weights, bf16 activations)
            parts = []
            for name, (x, w, kw) in zip(("QKV (LN)", "out-proj (cast)", "FFN1 (LN)",
                                          "FFN2 (cast)"), calls):
                w16 = {k: v for k, v in kw.items() if k != "act_quant"}
                parts.append(f"{name} {device_ms(lambda: gemm_small_m(x, w, site='check', **kw)):.4f}"
                             f" / {device_ms(lambda: gemm_small_m(x, w, site='check', **w16)):.4f}")
            say("  W8A8 / W8A16 ms per product of layer 0, M=1: " + ", ".join(parts))
        if lw["sqkv"] is None:  # bf16 or f32: one F.linear per product
            xs = [(x.to(w.dtype), w, kw.get("bias")) for x, w, kw in calls]
            lib_ms = device_ms(lambda: [Fn.linear(x, w, b if b is None else b.to(w.dtype)) for x, w, b in xs])
        elif act_quant:  # W8A8: one _int_mm per layer product
            lib_ms = int_mm_library_ms(calls, M)
        else:  # int8 W8A16: one _weight_int8pack_mm per product
            lib_ms = int8_library_ms(calls)
        nbytes = sum(w.numel() * w.element_size() + 4 * (M * (w.shape[0] + w.shape[1]))
                     + (0 if kw.get("scale") is None else 4 * w.shape[0]) for x, w, kw in calls)
        rate = F32_OPS_PER_S if f32 else BF16_OPS_PER_S
        # the operations in bf16-rate units: W8A8 products run at the int8 rate
        ops = sum(2 * M * w.shape[0] * w.shape[1] * (rate / INT8_OPS_PER_S if kw.get("act_quant")
                                                     else 1.0) for _, w, kw in calls)
        wname = ("w8a8 (head W8A16)" if act_quant else "int8" if lw["sqkv"] is not None
                 else ("f32" if f32 else "bf16"))
        entry("gemm_small_m", site, err, ms, pms, nbytes, ops, lib_ms,
              f"{unit}: {len(calls)} products, M={M}, {wname} weights", in_line, rate)

    def check_prep(site, lw, M, act_quant, in_line=True):
        """The prep kernel of gemm_small_m (the prologue once per product)
        against its plain version, on the prologues of one decode step: the
        LayerNorm rows of QKV, FFN1 and the head, and with act_quant also
        the cast rows of out-proj and FFN2 (W8A8 quantizes every layer
        product). bf16 rows within one bf16 ulp of the plain version's (its
        LayerNorm sums run in another order); W8A8 scales within 1e-6 of
        theirs and codes at most one apart (the same rounding halves may
        fall either way after an f32 LayerNorm), bitwise equal for a cast."""
        x_d = torch.randn((M, D), generator=g, device=dev)
        x_f = torch.relu(torch.randn((M, F), generator=g, device=dev))
        runs = []  # (x, ln, W8A8): the head's prologue stays bf16 (W8A16)
        for li in range(NL):
            runs += [(x_d, (lw["ln1s"][li], lw["ln1b"][li]), act_quant),
                     (x_d, (lw["ln2s"][li], lw["ln2b"][li]), act_quant)]
            if act_quant:
                runs += [(x_d, None, True), (x_f, None, True)]
        runs.append((x_d, (lw["fns"], lw["fnb"]), False))
        err = 0.0
        for x, ln, aq in runs[:4] + runs[-1:]:
            got = gemm_prep(x, ln=ln, act_quant=aq)
            ref = gemm_prep_plain(x, ln=ln, act_quant=aq)
            torch.cuda.synchronize()
            if aq:
                (qk, sk), (qp, sp) = got, ref
                dq = int((qk.int() - qp.int()).abs().max())
                ds = float(((sk - sp).abs() / sp).max())
                if ln is None and not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                    fail(f"gemm_small_m_prep@{site}: cast codes differ ({dq}) or scales ({ds})")
                if not (dq <= 1 and ds <= 1e-6):
                    fail(f"gemm_small_m_prep@{site}: codes {dq} apart, scales {ds} relative")
                err = max(err, float(dq))
            else:
                e = (got.float() - ref.float()).abs()
                ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0 ** -100))) - 7)
                if not bool((e <= ulp).all()):
                    fail(f"gemm_small_m_prep@{site}: bf16 rows beyond one ulp, max err {float(e.max())}")
                err = max(err, float(e.max()))
        ms = device_ms(lambda: [gemm_prep(x, ln=ln, act_quant=a) for x, ln, a in runs])
        pms = device_ms(lambda: [gemm_prep_plain(x, ln=ln, act_quant=a) for x, ln, a in runs])
        # f32 rows read once, the LayerNorm's two vectors, the rows written
        nbytes = sum(x.numel() * 4 + (0 if ln is None else 8 * x.shape[1])
                     + x.numel() * (1 if a else 2) + (4 * x.shape[0] if a else 0)
                     for x, ln, a in runs)
        ops = sum(x.numel() * (8 if ln is not None else 1) + (x.numel() * 3 if a else 0)
                  for x, ln, a in runs)
        # library: null -- no one PyTorch call normalizes, rounds (or
        # quantizes with a per-row scale) and writes the product's rows
        entry("gemm_small_m_prep", site, err, ms, pms, nbytes, ops, None,
              f"{len(runs)} launches: the prologues of one step, M={M},"
              f" {'W8A8 codes and scales' if act_quant else 'bf16 rows'}"
              f"{'; max_abs_err in codes' if act_quant else ''}", in_line, F32_OPS_PER_S)

    def check_attention(site, q, k, v, bounds, reps_layers, in_line=True, prefix=None,
                        beams=1, kv_scales=None, new_kv=None, slot=None):
        """The kernel against its plain version; with a prefix, the grouped
        mode (row b reads the text and prompt keys of prefix b // beams);
        with kv_scales, int8 K/V; with new_kv and slot, the own-column mode,
        whose written column must equal the plain version's bitwise."""
        B, _, Tq, _ = q.shape
        own = new_kv is not None
        gk = dict(prefix=prefix, beams=beams, kv_scales=kv_scales, new_kv=new_kv, slot=slot)
        k_run, v_run = (k.clone(), v.clone()) if own else (k, v)  # own: the kernel writes
        outk = masked_attention(q, k_run, v_run, bounds, site="check", **gk).float()
        # the plain version in f32 on the same (bf16- or int8-valued) inputs
        ref = masked_attention_plain(q.float(), k, v, bounds, **gk)
        torch.cuda.synchronize()
        if own:
            kp, vp = k.clone(), v.clone()
            write_column(kp, vp, new_kv, slot, kv_scales)
            if not (torch.equal(k_run, kp) and torch.equal(v_run, vp)):
                fail(f"masked_attention@{site}: the written cache differs from the plain"
                     f" version's (k equal {torch.equal(k_run, kp)}, v equal {torch.equal(v_run, vp)})")
        diff = (outk - ref).abs()
        err = float(diff.max())
        tol = torch.full_like(ref, 2e-5)  # f32 softmax and sums on both sides, in another order
        if not bool((diff <= tol).all()):
            i = int((diff - tol).argmax())
            fail(f"masked_attention@{site}: err {float(diff.flatten()[i])} > "
                 f"{float(tol.flatten()[i])} at |ref| {float(ref.abs().flatten()[i])}")
        # the same work in the batched layout: the prefix repeated per sample
        kf, vf, bf = (k_run, v_run, bounds) if prefix is None else \
            with_prefix(k_run, v_run, bounds, prefix, beams)
        C_all = kf.shape[2]
        ok = valid_keys(Tq, C_all, bf)  # [B, Tq, C]
        if own:  # the walk stops before the slot; the new column comes on top
            cut = slot + C_all - k.shape[2]
            ok = ok & (torch.arange(C_all, device=dev) < cut)
        nkeys = int(ok.sum()) + (B * Tq if own else 0)
        ms = device_ms(lambda: [masked_attention(q, k_run, v_run, bounds, site="check", **gk)
                                for _ in range(reps_layers)])
        pms = device_ms(lambda: [masked_attention_plain(q, k_run, v_run, bounds, **gk)
                                 for _ in range(reps_layers)])
        lib_ms = None  # int8 K/V: no one PyTorch call attends over int8 K/V with scales
        if kv_scales is None:
            # SDPA over the cache (own column: with the written column in its mask)
            lib_mask = ok.clone()
            if own:
                lib_mask[..., cut] = True
            qb, mask = q.to(kf.dtype), lib_mask[:, None]  # per-row boolean mask [B, 1, Tq, C]
            lib_ms = device_ms(lambda: [Fn.scaled_dot_product_attention(qb, kf, vf, attn_mask=mask)
                                        for _ in range(reps_layers)])
        # valid key rows read: the prefix's once per request, each row's own
        used = ok.any(1)  # [B, C]
        P = 0 if prefix is None else prefix[0].shape[2]
        rows = int(used[::beams, :P].sum() + used[:, P:].sum())
        # own column: the new k/v read in f32 and written in the cache type
        col = (2 * B * H * hd * (4 + kf.element_size())) if own else 0
        nbytes = reps_layers * (2 * rows * H * hd * kf.element_size()
                                + 2 * B * Tq * H * hd * q.element_size() + col)
        ops = reps_layers * 4 * nkeys * hd * H
        entry("masked_attention", site, err, ms, pms, nbytes, ops, lib_ms,
              f"{reps_layers} launch(es): B={B}{f' = {B // beams} x {beams} samples' if prefix is not None else ''},"
              f" Tq={Tq}, {rows} valid key rows read, f32 q/out, {kf.dtype} k/v"
              f"{', own column' if own else ''}".replace("torch.", ""),
              in_line, {torch.float32: F32_OPS_PER_S, torch.int8: INT8_OPS_PER_S}.get(
                  kf.dtype, BF16_OPS_PER_S))

    def check_flash_nar(site, x_len, audio_len, s_text, T):
        """The flash forward at the NAR's shapes against its plain version:
        q/k/v as the NAR hands them (views of the fused QKV product), its
        key-padding rule as segments (ok, ok), prefix T. On the valid rows
        (the NAR discards the others) each output element must lie within
        one bf16 ulp + 1e-5 of max|ref| of the plain version's f32 output,
        plus 2^-8 of sum(p |v|) / l: both round each p to bf16 once (at most
        2^-9 of p each way), the kernel at the running row max of its key
        tiles (as the JAX library's kernel does), the plain version at the
        final one. lse within 1e-3."""
        B = len(x_len)
        cols = torch.arange(T, device=dev)[None, :]
        seg = torch.where(cols < s_text, cols < rows_i32(x_len)[:, None],
                          (cols - s_text) < rows_i32(audio_len)[:, None]).to(torch.int32)
        qkv = torch.randn((B, T, 3 * D), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, T, H, hd).transpose(1, 2)
                   for i in range(3))
        o, lse = flash_attention_fwd(q, k, v, seg, seg, T, site="check")
        ref, lref = flash_attention_plain(q.float(), k, v, seg, seg, T)  # f32 out
        spread = flash_attention_plain(q.float(), k, v.abs(), seg, seg, T)[0]
        torch.cuda.synchronize()
        rows = seg.bool()[:, None, :, None].expand_as(ref)  # the valid query rows
        diff = (o.float() - ref).abs()[rows]
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -100))) - 7)[rows]
        one_ulp = ulp + 1e-5 * float(ref.abs().max())
        tol = one_ulp + 2.0 ** -8 * spread[rows]
        err, err_l = float(diff.max()), float((lse - lref).abs()[rows[..., 0]].max())
        if not (bool((diff <= tol).all()) and err_l <= 1e-3):
            i = int((diff - tol).argmax())
            fail(f"flash_attention_fwd@{site}: err {float(diff[i])} > {float(tol[i])}, lse err"
                 f" {err_l}")
        beyond = int((diff > one_ulp).sum())
        own = running_max_rounding(q, k, v, seg, T)
        beyond_own = int(((o.float() - own).abs()[rows] > one_ulp).sum())
        say(f"  flash_attention_fwd@{site}: valid rows within one bf16 ulp + 1e-5 of max for"
            f" {diff.numel() - beyond} of {diff.numel()} elements, the rest within the p-rounding"
            f" term (worst {float((diff / tol).max()):.3f} of its bound); lse err {err_l:.3e};"
            f" against the kernel's rounding order in plain PyTorch {beyond_own} beyond one ulp")
        ok = valid_pairs(seg, seg, T)
        pairs = int(ok.sum()) * H
        mask = ok[:, None]
        lib_ms = device_ms(lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        n = B * H * T * hd
        entry("flash_attention_fwd", site, err,
              device_ms(lambda: flash_attention_fwd(q, k, v, seg, seg, T, site="check")),
              device_ms(lambda: flash_attention_plain(q, k, v, seg, seg, T)),
              4 * n * 2 + B * H * T * 4 + 2 * B * T * 4, 4 * hd * pairs, lib_ms,
              f"1 launch: NAR, B={B}, H={H}, T={T}, bf16, segments (ok, ok), prefix T;"
              f" {int(seg.sum())} valid rows, {pairs} valid pairs")
        del qkv, q, k, v, o, ref, spread, own, mask, ok

    def check_sample(site, rows, greedy):
        logits = torch.randn((rows, VP), generator=g, device=dev) * 3
        u = None if greedy else torch.rand((rows, VP), generator=g, device=dev)
        tk, lk = sample_epilogue(logits, u, vocab=vocab, temperature=1.0, greedy=greedy, site="check")
        tp, lp = sample_epilogue_plain(logits, u, vocab=vocab, temperature=1.0, greedy=greedy)
        torch.cuda.synchronize()
        if not torch.equal(tk, tp):
            fail(f"sample_epilogue@{site}: tokens differ {tk.tolist()} vs {tp.tolist()}")
        err = float((lk - lp).abs().max())
        if not err <= 1e-4:
            fail(f"sample_epilogue@{site}: logprob err {err}")
        ms = device_ms(lambda: sample_epilogue(logits, u, vocab=vocab, temperature=1.0,
                                               greedy=greedy, site="check"))
        pms = device_ms(lambda: sample_epilogue_plain(logits, u, vocab=vocab, temperature=1.0,
                                                      greedy=greedy))
        nbytes = rows * VP * 4 * (1 if greedy else 2) + rows * 8
        # library: null — no one PyTorch call computes the Gumbel-argmax (or
        # argmax) together with the chosen token's log-softmax logprob
        entry("sample_epilogue", site, err, ms, pms, nbytes, 4 * rows * VP, None,
              f"1 launch: {rows} x {VP} logits, {'greedy' if greedy else 'Gumbel'}")

    boundary_total = 0

    def check_filtered(rows, top_k, top_p, in_line):
        """The filtered epilogue against its plain version on the same
        uniforms: kept sets equal, except at a token whose mass above lies
        within 1e-5 of top_p (the f32 mass sums run in another order);
        tokens equal and logprobs at 1e-4 on every row whose kept set is
        equal."""
        nonlocal boundary_total
        site, temp = "decode_block_fused_filtered", 1.0
        logits = torch.randn((rows, VP), generator=g, device=dev) * 3
        u = torch.rand((rows, VP), generator=g, device=dev)
        kw = dict(vocab=vocab, temperature=temp, greedy=False, top_k=top_k, top_p=top_p)
        tk, lk, kk = sample_epilogue(logits, u, return_keep=True, site="check", **kw)
        tp, lp, kp = sample_epilogue_plain(logits, u, return_keep=True, **kw)
        torch.cuda.synchronize()
        diff = kk[:, :vocab] != kp[:, :vocab]
        if bool(diff.any()):
            lanes = torch.arange(VP, device=dev)
            scaled = torch.where(lanes < vocab, logits, -1e30) / temp
            f = torch.where(topk_keep_mask(scaled, top_k), scaled, -1e9).double()
            prob = torch.softmax(f, dim=-1)
            for r, i in diff.nonzero().tolist():
                above = float(prob[r][f[r] > f[r, i]].sum())
                if abs(above - top_p) > 1e-5:
                    fail(f"sample_epilogue@{site}: row {r} token {i} kept differently, mass"
                         f" above {above} vs top_p {top_p}")
        boundary = int(diff.sum())
        boundary_total += boundary
        same = ~diff.any(1)
        if not torch.equal(tk[same], tp[same]):
            fail(f"sample_epilogue@{site}: tokens differ {tk.tolist()} vs {tp.tolist()}")
        err = float((lk[same] - lp[same]).abs().max()) if bool(same.any()) else 0.0
        if not err <= 1e-4:
            fail(f"sample_epilogue@{site}: logprob err {err}")
        ms = device_ms(lambda: sample_epilogue(logits, u, site="check", **kw))
        pms = device_ms(lambda: sample_epilogue_plain(logits, u, **kw))
        nbytes = rows * VP * 4 * 2 + rows * 8
        # what the function needs per logit, not the bisection that runs it:
        # the scale, one pass per filter (a compare for top-k; an exp, a sum
        # and a compare for top-p), the Gumbel draw (two logs, an add, the
        # argmax compare) and the log-softmax's exp and sum
        ops = rows * VP * (1 + 1 + 3 + 4 + 2)
        # library: null — no one PyTorch call filters, draws and returns
        # the chosen token's logprob
        entry("sample_epilogue", site, err, ms, pms, nbytes, ops, None,
              f"1 launch: {rows} x {VP} logits, top_k={top_k}, top_p={top_p}, Gumbel;"
              f" {boundary} kept-set difference(s) at the nucleus boundary", in_line,
              F32_OPS_PER_S)

    def decode_q(B, Tq):
        """Queries as the decode forward hands them over: a strided view of
        the QKV product [B·Tq, 3D]."""
        qkv = torch.randn((B * Tq, 3 * D), generator=g, device=dev)
        return qkv[:, :D].view(B, Tq, H, hd).transpose(1, 2)

    def rows_i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    # ---- phase 3: every kernel against its plain version ---------------------
    with phase("3 kernels vs plain", 240):
        check_gemm("decode_block_fused", draft, 1, "one draft step")
        check_gemm("decode_verify", packed, 8, "one verify pass")
        one = attention_bounds(1, x_len=X_LEN, s_text=S_TEXT, audio_len=POS0 + 1, q_off=1,
                               device=dev)
        check_attention("decode_block_fused", decode_q(1, 1), cache_k[0][None], cache_v[0][None],
                        one, NL)
        check_attention("decode_verify", decode_q(1, 8), cache_k[0][None], cache_v[0][None],
                        one, NL)
        T_NAR, S_NAR = 2304, 256
        check_flash_nar("flash_attention", [150], [1058], S_NAR, T_NAR)
        # the verify pass at decode_steps = 16: 16 queries per head
        check_attention("decode_verify", decode_q(1, 16), cache_k[0][None], cache_v[0][None],
                        one, NL, in_line=False)
        check_prep("decode_verify", packed, 8, False)
        check_sample("decode_block_fused", 1, False)
        check_sample("decode_verify", 8, True)

    # ---- phase 3b: the batched sites -----------------------------------------
    with phase("3b kernels vs plain, batched", 300):
        B = len(XL_B)
        kb, vb = (torch.randn((B, H, C_B, hd), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        gen = [600, 350, 1200, 90]  # generated frames per row (own column included below)
        bb = attention_bounds(B, x_len=rows_i32(XL_B), s_text=S_TEXT,
                              audio_len=rows_i32(PL_B) + 1, q_off=1,
                              gen_lo=S_TEXT + P_AUDIO, gen_len=rows_i32(gen) + 1, device=dev)
        check_attention("decode_block_fused_batched", decode_q(B, 1), kb, vb, bb, NL)
        check_flash_nar("flash_attention_batched", [20, 52, 150, 256], [832, 892, 1158, 2046],
                        S_NAR, T_NAR)
        check_gemm("decode_block_fused_batched", packed, 4, "one batched step")
        check_gemm("decode_block_fused_batched", packed, 8, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", draft, 4, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", draft, 8, "one batched step", in_line=False)
        check_sample("decode_block_fused_batched", 8, False)

    # ---- phase 3c: best_of, filtered sampling, more rows, f32 ----------------
    with phase("3c kernels vs plain, best_of / filtered / f32", 300):
        for rows in (1, 20):
            for top_k in (10, 50):
                for top_p in (0.9, 0.5):
                    check_filtered(rows, top_k, top_p,
                                   in_line=(rows, top_k, top_p) == (1, 50, 0.9))
        say(f"  filtered epilogue: {boundary_total} kept-set difference(s) at the nucleus"
            f" boundary over the 8 checks")
        # one request x 5 samples: "Hello world." with paimon (phase 5d)
        BEAMS = 5
        pl1 = len(api._load_prompt("paimon")[0])
        P1 = S_TEXT + 512
        pk1, pv1 = (torch.randn((1, H, P1, hd), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))
        kg1, vg1 = (torch.randn((BEAMS, H, T_AUDIO + 8, hd), generator=g,
                                device=dev).to(torch.bfloat16) for _ in range(2))
        b1 = attention_bounds(BEAMS, x_len=X_LEN, s_text=S_TEXT, audio_len=pl1 + 1, q_off=1,
                              gen_lo=0, gen_len=rows_i32([POS0 + 1] * BEAMS), device=dev)
        check_attention("decode_block_fused_beams", decode_q(BEAMS, 1), kg1, vg1, b1, NL,
                        prefix=(pk1, pv1), beams=BEAMS)
        # 4 requests x 5 samples: the batch of phase 5b with best_of=5
        rep = lambda t: t.repeat_interleave(BEAMS)  # noqa: E731
        P4 = S_TEXT + P_AUDIO
        pk4, pv4 = (torch.randn((4, H, P4, hd), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))
        kg4, vg4 = (torch.randn((4 * BEAMS, H, T_GEN + 8, hd), generator=g,
                                device=dev).to(torch.bfloat16) for _ in range(2))
        b4 = attention_bounds(4 * BEAMS, x_len=rep(rows_i32(XL_B)), s_text=S_TEXT,
                              audio_len=rep(rows_i32(PL_B)) + 1, q_off=1, gen_lo=0,
                              gen_len=rep(rows_i32([600, 350, 1200, 90])) + 1, device=dev)
        check_attention("decode_block_fused_grouped", decode_q(4 * BEAMS, 1), kg4, vg4, b4, NL,
                        prefix=(pk4, pv4), beams=BEAMS)
        # more than 8 rows: the batch of 16 and the 4 x 5 samples (bitwise rows)
        check_gemm("decode_block_fused_batched", packed, 16, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", packed, 20, "one batched step", in_line=False)
        # compute_dtype="float32": f32 weights, f32 cache
        packed32 = pack_layer_weights(bundle.model, torch.float32)
        check_gemm("decode_block_fused", packed32, 1, "one f32 step", in_line=False)
        check_attention("decode_block_fused", decode_q(1, 1), cache_k[0][None].float(),
                        cache_v[0][None].float(), one, NL, in_line=False)
        # ... and its verify pass (speculative="auto" drafts with int8 and
        # verifies 8 positions with the f32 weights over the f32 cache)
        check_gemm("decode_verify", packed32, 8, "one f32 verify pass", in_line=False)
        check_attention("decode_verify", decode_q(1, 8), cache_k[0][None].float(),
                        cache_v[0][None].float(), one, NL, in_line=False)
        del pk1, pv1, kg1, vg1, pk4, pv4, kg4, vg4, packed32

    # ---- phase 3d: the int8 KV cache, w8a8 and the single steps --------------
    def decode_qkv(B):
        """q and the new k/v as the decode forward hands them over: strided
        [B, H, 1, hd] views of the QKV product [B, 3D]."""
        qkv = torch.randn((B, 3 * D), generator=g, device=dev).view(B, 1, 3, H, hd)
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))

    def int8_pair(kc, vc):
        """bf16 caches [B, H, C, hd] of one layer → int8 caches and their
        (ks, vs) [H], with the batch-wide scales of the engine."""
        k8, v8, (ks, vs) = AR.int8_caches(kc[None], vc[None])
        return k8[0], v8[0], (ks[0].contiguous(), vs[0].contiguous())

    with phase("3d kernels vs plain, int8kv / w8a8 / single steps", 300):
        for M in (1, 4, 8, 16, 20):
            check_gemm("decode_block_fused_w8a8", draft, M, "one w8a8 step", in_line=M == 1,
                       act_quant=True)
        check_prep("decode_block_fused_w8a8", draft, 1, True)
        # int8 K/V in the own-column mode, at the shapes of the int8kv blocks:
        # one request ...
        k8, v8, sc8 = int8_pair(cache_k[0][None], cache_v[0][None])
        q, nk, nv = decode_qkv(1)
        check_attention("decode_block_fused_int8kv", q, k8, v8, one, NL,
                        kv_scales=sc8, new_kv=(nk, nv), slot=S_TEXT + POS0)
        # ... a batch of 4 (the generated rows shared by position) ...
        B = len(XL_B)
        kb, vb = (torch.randn((B, H, C_B, hd), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        k8, v8, sc8 = int8_pair(kb, vb)
        b8 = attention_bounds(B, x_len=rows_i32(XL_B), s_text=S_TEXT,
                              audio_len=rows_i32(PL_B) + 1, q_off=1,
                              gen_lo=S_TEXT + P_AUDIO, gen_len=601, device=dev)
        q, nk, nv = decode_qkv(B)
        check_attention("decode_block_fused_int8kv", q, k8, v8, b8, NL, in_line=False,
                        kv_scales=sc8, new_kv=(nk, nv), slot=S_TEXT + P_AUDIO + 600)
        # ... and 4 requests x 5 samples, the int8 prefix once per request
        BEAMS = 5
        pk, pv = (torch.randn((B, H, S_TEXT + P_AUDIO, hd), generator=g,
                              device=dev).to(torch.bfloat16) for _ in range(2))
        pk8, pv8, sc8 = int8_pair(pk, pv)
        kg8 = torch.zeros((B * BEAMS, H, T_GEN + 8, hd), dtype=torch.int8, device=dev)
        kg8[:, :, :600] = torch.randint(-127, 128, (B * BEAMS, H, 600, hd), generator=g,
                                        device=dev, dtype=torch.int8)
        vg8 = kg8.flip(0).contiguous()
        rep = lambda t: t.repeat_interleave(BEAMS)  # noqa: E731
        bg8 = attention_bounds(B * BEAMS, x_len=rep(rows_i32(XL_B)), s_text=S_TEXT,
                               audio_len=rep(rows_i32(PL_B)) + 1, q_off=1, gen_lo=0,
                               gen_len=601, device=dev)
        q, nk, nv = decode_qkv(B * BEAMS)
        check_attention("decode_block_fused_int8kv", q, kg8, vg8, bg8, NL, in_line=False,
                        prefix=(pk8, pv8), beams=BEAMS, kv_scales=sc8, new_kv=(nk, nv), slot=600)
        del kb, vb, k8, v8, pk, pv, pk8, pv8, kg8, vg8
        # the own-column mode over the bf16 cache of one request: the step
        # ops' and decode_attention's attention (the walk stops before the
        # slot; the bounds as those ops build them)
        step_b = attention_bounds(1, x_len=X_LEN, s_text=S_TEXT, audio_len=POS0, q_off=0,
                                  device=dev)
        for site in ("decode_attention", "decode_step", "decode_step_fused"):
            q, nk, nv = decode_qkv(1)
            check_attention(site, q, cache_k[0][None], cache_v[0][None], step_b,
                            1 if site == "decode_attention" else NL, new_kv=(nk, nv),
                            slot=S_TEXT + POS0)
        check_gemm("decode_step", packed, 1, "one decode_step")
        check_gemm("decode_step_fused", packed, 1, "one decode_step_fused")
        check_sample("decode_step_fused", 1, False)

    # ---- phase 3e: the training attention, forward and backward --------------
    with phase("3e training attention vs plain", 300):
        train_kernel_checks(dev, entry, device_ms, g)

    # ---- phase 3f: head dim 128 (d_model 1024, 8 heads) -----------------------
    loader.reset_launch_counts()
    with phase("3f head dim 128", 420):
        H8, HD8 = 8, 128
        cfg128 = dataclasses.replace(cfg, num_heads=H8)
        b128 = api.preload_models(random_weights=True, seed=0, device=dev, cfg=cfg128)
        packed8, draft8 = b128.pipeline.packed_weights(True)
        ck8, cv8 = (torch.randn((NL, H8, C, HD8), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))

        def qkv8(Tq):
            qkv = torch.randn((Tq, 3 * D), generator=g, device=dev).view(1, Tq, 3, H8, HD8)
            return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))

        # the decode attention at hd 128: a draft step, a verify pass, an int8 K/V
        # own-column step, and 16 queries
        check_attention("decode_block_fused" + HD128, qkv8(1)[0], ck8[0][None], cv8[0][None],
                        one, NL)
        check_attention("decode_verify" + HD128, qkv8(8)[0], ck8[0][None], cv8[0][None], one, NL)
        check_attention("decode_verify" + HD128, qkv8(16)[0], ck8[0][None], cv8[0][None], one,
                        NL, in_line=False)
        k8, v8, sc8 = int8_pair(ck8[0][None], cv8[0][None])
        q, nk, nv = qkv8(1)
        check_attention("decode_block_fused_int8kv", q, k8, v8, one, NL, in_line=False,
                        kv_scales=sc8, new_kv=(nk, nv), slot=S_TEXT + POS0)
        # the training attention at hd 128, as phase 3e
        train_kernel_checks(dev, entry, device_ms, g, H=H8, hd=HD8, suffix=HD128)
        # the decode ops against the CPU plain path, as phase 4
        cpu8 = {k: (None if t is None else t.cpu()) for k, t in draft8.items()}
        pcpu8 = {k: (None if t is None else t.cpu()) for k, t in packed8.items()}
        pe8 = b128.model.pe
        kw = dict(x_len=X_LEN, audio_pos=POS0, remaining=2 ** 30, temperature=1.0, steps=7,
                  s_text=S_TEXT, vocab=vocab, eos=eos, stochastic=False)
        z, nb = torch.zeros((1,), device=dev), torch.zeros((1,), dtype=torch.bool, device=dev)
        ck, cv, ck_c, cv_c = ck8.clone(), cv8.clone(), ck8.cpu(), cv8.cpu()
        rg = decode_block_fused(torch.tensor([17], device=dev), z, nb, z, draft8, ck, cv, pe8, **kw)
        rc = decode_block_fused(torch.tensor([17]), z.cpu(), nb.cpu(), z.cpu(), cpu8, ck_c, cv_c,
                                pe8.cpu(), **kw)
        err = float((rg.step_logits.cpu() - rc.step_logits).abs().max())
        scale = float(rc.step_logits.abs().max())
        if rg.fed.tolist() != rc.fed.tolist() or not err <= 2e-2 * max(1.0, scale):
            fail(f"3f decode_block_fused hd 128: tokens {rg.fed.tolist()} vs {rc.fed.tolist()},"
                 f" logits err {err} (scale {scale})")
        fed = torch.cat([rg.fed, rg.next_tok])
        lg = decode_verify(fed, packed8, ck, cv, pe8, x_len=X_LEN, audio_pos=POS0, s_text=S_TEXT)
        lc = decode_verify(fed.cpu(), pcpu8, ck_c, cv_c, pe8.cpu(), x_len=X_LEN, audio_pos=POS0,
                           s_text=S_TEXT)
        err2 = float((lg.cpu() - lc).abs().max())
        scale2 = float(lc.abs().max())
        if not (err2 <= 2e-2 * max(1.0, scale2)
                and torch.equal(lg.cpu()[:, :vocab].argmax(-1), lc[:, :vocab].argmax(-1))):
            fail(f"3f decode_verify hd 128: logits err {err2} (scale {scale2}) or argmax differs")
        say(f"  hd 128: decode_block_fused (int8, K-1=7, greedy) tokens equal to the CPU's, logits"
            f" max_abs_err {err:.3e} (scale {scale:.1f}); decode_verify (bf16, K=8) argmax equal,"
            f" logits max_abs_err {err2:.3e} (scale {scale2:.1f})")
        del ck, cv, ck_c, cv_c, ck8, cv8, k8, v8, cpu8, pcpu8
        # the entry points at hd 128, their launches counted for the hd-128 rows
        loader.reset_launch_counts()
        train_head_dim(dev, cfg128)
        wave = api.generate_audio("Hello world.", prompt="paimon", language="en", top_k=1,
                                  max_duration=0.86)
        if not (len(wave) > 0 and np.isfinite(wave).all()):
            fail("3f generate_audio at hd 128: no finite wave")
        say(f"  hd 128: generate_audio greedy, {len(b128.last.codes)} frames through the kernels")
        counts_hd128 = dict(loader.launch_counts)
        api._bundle = bundle
        del b128, packed8, draft8
        torch.cuda.empty_cache()

    # ---- phase 4: the decode ops against the plain (CPU) path -----------------
    with phase("4 decode ops vs plain", 240):
        cpu = lambda lw: {k: (None if t is None else t.cpu()) for k, t in lw.items()}  # noqa: E731
        pe = bundle.model.pe
        ck, cv = cache_k.clone(), cache_v.clone()
        ck_c, cv_c = cache_k.cpu(), cache_v.cpu()
        z = lambda d: torch.zeros((1,), device=d)  # noqa: E731
        nb = lambda d: torch.zeros((1,), dtype=torch.bool, device=d)  # noqa: E731
        kw = dict(x_len=X_LEN, audio_pos=POS0, remaining=2 ** 30, temperature=1.0, steps=7,
                  s_text=S_TEXT, vocab=vocab, eos=eos, stochastic=False)
        t0 = time.perf_counter()
        rg = decode_block_fused(torch.tensor([17], device=dev), z(dev), nb(dev), z(dev),
                                draft, ck, cv, pe, **kw)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        rc = decode_block_fused(torch.tensor([17]), z("cpu"), nb("cpu"), z("cpu"),
                                cpu(draft), ck_c, cv_c, pe.cpu(), **kw)
        if rg.fed.tolist() != rc.fed.tolist() or int(rg.next_tok) != int(rc.next_tok):
            fail(f"decode_block_fused: tokens {rg.fed.tolist()}+{int(rg.next_tok)} vs "
                 f"{rc.fed.tolist()}+{int(rc.next_tok)}")
        err = float((rg.step_logits.cpu() - rc.step_logits).abs().max())
        scale = float(rc.step_logits.abs().max())
        kv_err = float((ck.cpu().float() - ck_c.float()).abs().max())
        if not (err <= 2e-2 * max(1.0, scale) and kv_err <= 0.1):
            fail(f"decode_block_fused: logits err {err} (scale {scale}), kv err {kv_err}")
        say(f"  decode_block_fused (int8, K-1=7, greedy): tokens equal, logits max_abs_err {err:.3e}"
            f" (scale {scale:.1f}), kv max_abs_err {kv_err:.3e}, {t_gpu * 1e3:.1f} ms host clock")
        fed = torch.cat([rg.fed, rg.next_tok])
        t0 = time.perf_counter()
        lg = decode_verify(fed, packed, ck, cv, pe, x_len=X_LEN, audio_pos=POS0, s_text=S_TEXT)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        lc = decode_verify(fed.cpu(), cpu(packed), ck_c, cv_c, pe.cpu(), x_len=X_LEN,
                           audio_pos=POS0, s_text=S_TEXT)
        err = float((lg.cpu() - lc).abs().max())
        scale = float(lc.abs().max())
        if not err <= 2e-2 * max(1.0, scale):
            fail(f"decode_verify: logits err {err} (scale {scale})")
        if not torch.equal(lg.cpu()[:, :vocab].argmax(-1), lc[:, :vocab].argmax(-1)):
            fail("decode_verify: argmax disagrees with the plain path")
        say(f"  decode_verify (bf16, K=8): argmax equal, logits max_abs_err {err:.3e}"
            f" (scale {scale:.1f}), {t_gpu * 1e3:.1f} ms host clock")
        # decode_steps = 16: 16 positions in one pass (masked_attention at Tq = 16)
        fed16 = torch.cat([fed, fed.flip(0)])
        lg = decode_verify(fed16, packed, ck, cv, pe, x_len=X_LEN, audio_pos=POS0 + 8,
                           s_text=S_TEXT)
        lc = decode_verify(fed16.cpu(), cpu(packed), ck_c, cv_c, pe.cpu(), x_len=X_LEN,
                           audio_pos=POS0 + 8, s_text=S_TEXT)
        err = float((lg.cpu() - lc).abs().max())
        scale = float(lc.abs().max())
        if not (err <= 2e-2 * max(1.0, scale)
                and torch.equal(lg.cpu()[:, :vocab].argmax(-1), lc[:, :vocab].argmax(-1))):
            fail(f"decode_verify K=16: logits err {err} (scale {scale}) or argmax disagrees")
        say(f"  decode_verify (bf16, K=16): argmax equal, logits max_abs_err {err:.3e}"
            f" (scale {scale:.1f})")
        del ck, cv, ck_c, cv_c

    # ---- phase 4b: the batched decode op against its rows run alone ----------
    with phase("4b batched decode vs single rows", 240):
        B = len(XL_B)
        rng = np.random.RandomState(0)
        reqs = [(rng.randint(5, 500, size=x).astype(np.int32), np.zeros(x, np.int32),
                 rng.randint(0, 1024, size=p).astype(np.int32) if p else None)
                for x, p in zip(XL_B, PL_B)]
        pb = AR.pad_batched_requests(reqs, eos, cfg.num_quantizers, (128, 256), (512, 1024, 2048))
        if (pb["s_text"], pb["p_audio"], pb["t_gen"]) != (S_TEXT, P_AUDIO, T_GEN):
            fail(f"4b: buckets {pb['s_text']}, {pb['p_audio']}, {pb['t_gen']}")
        xl, pl = rows_i32(XL_B), rows_i32(PL_B)
        y_init = torch.cat([torch.full((B, 1), cfg.bos_id, device=dev),
                            torch.as_tensor(pb["prompt_pad"], device=dev).long()], dim=1)
        text = torch.as_tensor(pb["text"], device=dev)
        lang = torch.as_tensor(pb["lang"], device=dev)
        pre = [AR.prefill(bundle.model, cfg, text[r:r + 1], lang[r:r + 1], xl[r:r + 1],
                          y_init[r:r + 1], pl[r:r + 1], s_text=S_TEXT, p_audio=P_AUDIO, C=C_B,
                          dtype=torch.bfloat16) for r in range(B)]  # each request alone
        ck0 = torch.cat([p[0] for p in pre], dim=1)
        cv0 = torch.cat([p[1] for p in pre], dim=1)
        tok0 = torch.cat([p[2] for p in pre]).argmax(-1).to(torch.int32)
        kw = dict(temperature=1.0, steps=8, s_text=S_TEXT, vocab=vocab, eos=eos,
                  stochastic=False, batched=True, p_audio=P_AUDIO)
        for name, lw in (("bf16", packed), ("int8", draft)):
            ck, cv = ck0.clone(), cv0.clone()
            singles = [(ck0[:, r:r + 1].clone(), cv0[:, r:r + 1].clone()) for r in range(B)]
            tok, one_tok = tok0, [tok0[r:r + 1] for r in range(B)]
            err, scale = 0.0, 0.0
            for blk in range(2):  # the first two blocks: generated rows 0..15
                zb = torch.zeros((B,), device=dev)
                rb = decode_block_fused(tok, zb, zb.bool(), zb, lw, ck, cv, bundle.model.pe,
                                        x_len=xl, audio_pos=8 * blk, prompt_len=pl,
                                        remaining=torch.full((B,), 2 ** 30, device=dev), **kw)
                for r in range(B):
                    z1 = torch.zeros((1,), device=dev)
                    r1 = decode_block_fused(one_tok[r], z1, z1.bool(), z1, lw, *singles[r],
                                            bundle.model.pe, x_len=xl[r:r + 1],
                                            audio_pos=8 * blk, prompt_len=pl[r:r + 1],
                                            remaining=torch.full((1,), 2 ** 30, device=dev), **kw)
                    if rb.fed[:, r].tolist() != r1.fed[:, 0].tolist():
                        fail(f"4b {name} block {blk} row {r}: fed {rb.fed[:, r].tolist()} vs "
                             f"alone {r1.fed[:, 0].tolist()}")
                    err = max(err, float((rb.step_logits[:, r] - r1.step_logits[:, 0]).abs().max()))
                    scale = max(scale, float(r1.step_logits[:, 0, :vocab].abs().max()))
                    one_tok[r] = r1.next_tok
                tok = rb.next_tok
            if not err <= 1e-2 * max(1.0, scale):
                fail(f"4b {name}: step logits err {err} at scale {scale}")
            say(f"  decode_block_fused batched ({name}, K=8, B={B}, 2 blocks): fed tokens equal"
                f" per row, step logits max_abs_err {err:.3e} against each row alone (scale {scale:.1f})")
        del ck, cv, ck0, cv0, singles, pre

    # ---- phase 4c: the grouped batched decode against its expanded rows -------
    with phase("4c grouped decode vs expanded rows", 240):
        B, BEAMS = len(XL_B), 5
        RB, P = B * BEAMS, S_TEXT + P_AUDIO
        pk, pv, lg0 = AR.prefill(bundle.model, cfg, text, lang, xl, y_init, pl, s_text=S_TEXT,
                                 p_audio=P_AUDIO, C=P, dtype=torch.bfloat16)
        rep = lambda t: t.repeat_interleave(BEAMS, dim=0)  # noqa: E731
        ck_g = torch.zeros((NL, RB, H, T_GEN + 8, hd), dtype=torch.bfloat16, device=dev)
        cv_g = torch.zeros_like(ck_g)
        ck_e = torch.zeros((NL, RB, H, P + T_GEN + 8, hd), dtype=torch.bfloat16, device=dev)
        cv_e = torch.zeros_like(ck_e)
        ck_e[:, :, :, :P] = pk.repeat_interleave(BEAMS, dim=1)
        cv_e[:, :, :, :P] = pv.repeat_interleave(BEAMS, dim=1)
        tok_g = tok_e = rep(lg0.argmax(-1).to(torch.int32))
        zb = torch.zeros((RB,), device=dev)
        kw = dict(x_len=rep(xl), prompt_len=rep(pl), remaining=torch.full((RB,), 2 ** 30, device=dev),
                  temperature=1.0, steps=8, s_text=S_TEXT, vocab=vocab, eos=eos,
                  stochastic=True, batched=True, p_audio=P_AUDIO)
        for blk in range(2):
            rg = decode_block_fused(tok_g, zb, zb.bool(), zb, packed, ck_g, cv_g, bundle.model.pe,
                                    audio_pos=8 * blk, prefix=(pk, pv), beams=BEAMS,
                                    generator=torch.Generator(device=dev).manual_seed(blk), **kw)
            re_ = decode_block_fused(tok_e, zb, zb.bool(), zb, packed, ck_e, cv_e,
                                     bundle.model.pe, audio_pos=8 * blk,
                                     generator=torch.Generator(device=dev).manual_seed(blk), **kw)
            if not (torch.equal(rg.fed, re_.fed) and torch.equal(rg.step_logits, re_.step_logits)
                    and torch.equal(rg.sum_logprobs, re_.sum_logprobs)):
                err = float((rg.step_logits - re_.step_logits).abs().max())
                fail(f"4c block {blk}: grouped rows differ from the expanded rows (fed equal:"
                     f" {torch.equal(rg.fed, re_.fed)}, logits max_abs_err {err})")
            tok_g, tok_e = rg.next_tok, re_.next_tok
        distinct = len({tuple(rg.fed[:, r].tolist()) for r in range(RB)})
        say(f"  decode_block_fused grouped (bf16, K=8, {B} requests x {BEAMS} samples, sampled,"
            f" 2 blocks): fed tokens, step logits and logprob sums bitwise equal to the {RB}"
            f" expanded rows; {distinct} distinct token rows of {RB}")
        del ck_g, cv_g, ck_e, cv_e, pk, pv

    # ---- phase 4d: the new decode ops against the plain (CPU) path ------------
    with phase("4d int8kv / w8a8 blocks, single steps, decode_attention vs plain", 300):
        pe = bundle.model.pe
        tok0 = torch.tensor([17], device=dev)

        def compare(name, tok_g, tok_c, lg, lc, extra=""):
            if tok_g != tok_c:
                fail(f"4d {name}: greedy tokens {tok_g} on the card vs {tok_c} on the CPU")
            err = float((lg.cpu() - lc).abs().max())
            scale = float(lc.abs().max())
            if not err <= 1e-2 * max(1.0, scale):
                fail(f"4d {name}: logits err {err} (scale {scale})")
            say(f"  {name}: greedy tokens equal, logits max_abs_err {err:.3e} (scale {scale:.1f}){extra}")

        # the K-step blocks, 8 steps: int8 caches, and W8A8 products
        k5, v5, scales = AR.int8_caches(cache_k[:, None], cache_v[:, None])
        for name, caches, quant in (
                ("decode_block_fused int8kv (K=8)", (k5[:, 0], v5[:, 0]), dict(kv_scales=scales)),
                ("decode_block_fused w8a8 (K=8)", (cache_k, cache_v), dict(act_quant=True))):
            kw = dict(x_len=X_LEN, audio_pos=POS0, remaining=2 ** 30, temperature=1.0, steps=8,
                      s_text=S_TEXT, vocab=vocab, eos=eos, stochastic=False)
            z, nb = torch.zeros((1,), device=dev), torch.zeros((1,), dtype=torch.bool, device=dev)
            ck, cv = (c.clone() for c in caches)
            rg = decode_block_fused(tok0, z, nb, z, draft, ck, cv, pe, **kw, **quant)
            ck_c, cv_c = (c.cpu() for c in caches)
            quant_c = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else v)
                       for k, v in quant.items()}
            rc = decode_block_fused(tok0.cpu(), z.cpu(), nb.cpu(), z.cpu(), cpu(draft), ck_c, cv_c,
                                    pe.cpu(), **kw, **quant_c)
            col = slice(S_TEXT + POS0, S_TEXT + POS0 + 8)
            kv_err = float((ck[:, :, col].cpu().float() - ck_c[:, :, col].float()).abs().max())
            compare(name, rg.fed.tolist() + [int(rg.next_tok)], rc.fed.tolist() + [int(rc.next_tok)],
                    rg.step_logits, rc.step_logits, f", written columns max_abs_err {kv_err:.3e}")
            if not kv_err <= (1.0 if "int8kv" in name else 0.1):
                fail(f"4d {name}: written columns differ by {kv_err}")
        del k5, v5

        # decode_step and decode_step_fused, 8 steps each
        for fused in (False, True):
            outs = []
            for d in (dev, torch.device("cpu")):
                lw = packed if d.type == "cuda" else cpu(packed)
                ck, cv = cache_k[:, None].to(d, copy=True), cache_v[:, None].to(d, copy=True)
                tok, toks, logits = tok0.to(d), [], []
                for k in range(8):
                    if fused:
                        tok, lp = decode_step_fused(tok, lw, ck, cv, pe.to(d), x_len=X_LEN,
                                                    audio_pos=POS0 + k, s_text=S_TEXT, vocab=vocab,
                                                    temperature=1.0, greedy=True)
                        logits.append(lp.float())
                    else:
                        lg = decode_step(embed(tok, lw, pe.to(d)[POS0 + k]), lw, ck, cv,
                                         x_len=X_LEN, audio_pos=POS0 + k, s_text=S_TEXT)
                        tok = lg[:, :vocab].argmax(-1)
                        logits.append(lg)
                    toks.append(int(tok))
                outs.append((toks, torch.stack(logits).cpu()))
            (tg, lg), (tc, lc) = outs
            compare("decode_step_fused (8 steps, logprobs)" if fused else "decode_step (8 steps)",
                    tg, tc, lg, lc)

        # decode_attention, layer 0, 8 positions
        errs = []
        ck, cv = cache_k[0][None].clone(), cache_v[0][None].clone()
        ck_c, cv_c = ck.cpu(), cv.cpu()
        for k in range(8):
            q, nk, nv = (t[:, :, 0].contiguous() for t in decode_qkv(1))
            og = decode_attention(q, nk, nv, ck, cv, X_LEN, POS0 + k, s_text=S_TEXT)
            oc = decode_attention(q.cpu(), nk.cpu(), nv.cpu(), ck_c, cv_c, X_LEN, POS0 + k,
                                  s_text=S_TEXT)
            errs.append(float((og.cpu() - oc).abs().max()))
        if not (max(errs) <= 2e-5 and torch.equal(ck.cpu(), ck_c) and torch.equal(cv.cpu(), cv_c)):
            fail(f"4d decode_attention: output errs {errs}, caches equal"
                 f" {torch.equal(ck.cpu(), ck_c)}/{torch.equal(cv.cpu(), cv_c)}")
        say(f"  decode_attention (8 positions): output max_abs_err {max(errs):.3e}, the 8 written"
            " columns and the rest of the cache bitwise equal to the CPU's")
        del ck, cv, ck_c, cv_c

    # ---- phases 5 and 6: the single-request path -----------------------------
    loader.reset_launch_counts()
    frames_total = 0

    def run(label, **kw):
        nonlocal frames_total
        t0 = time.perf_counter()
        wave = api.generate_audio(**kw)
        secs = time.perf_counter() - t0
        res = bundle.last
        n = len(res.codes)
        if not (n > 0 and wave.ndim == 1 and len(wave) == n * 320 and np.isfinite(wave).all()):
            fail(f"{label}: wave of {len(wave)} samples for {n} frames, finite={np.isfinite(wave).all()}")
        if res.codes.min() < 0 or res.codes.max() >= 1024:
            fail(f"{label}: codes outside [0, 1024)")
        frames_total += n
        it = max(res.ar.iterations, 1)
        say(f"  {label}: {n} frames ({n / 75:.2f} s audio) in {secs:.2f} s, RTF {secs / (n / 75):.4f},"
            f" AR {res.seconds['ar']:.2f} s / NAR {res.seconds['nar']:.2f} s / Vocos"
            f" {res.seconds.get('vocos', 0):.2f} s, {res.ar.iterations} iterations,"
            f" {res.ar.accepted_drafts / it:.2f} accepted drafts per iteration")
        return res.codes

    with phase("5 generate_audio", 300):
        run("sampled (top_k=-100)", text="Hello world.", prompt="paimon", language="en", seed=0)
        run("greedy (top_k=1)", text="Hello world.", prompt="paimon", language="en", top_k=1)
    with phase("6 generate_audio, NAR >= 1536", 300):
        run("long prompt, max_duration 4 s", text="The quick brown fox jumps over the lazy dog.",
            prompt="fuxuan", language="en", max_duration=4.0, seed=1)
    counts_single = dict(loader.launch_counts)
    frames_single = frames_total

    # ---- phases 5b and 5c: the batched path ----------------------------------
    base_ecfg, base_pipe = bundle.ecfg, bundle.pipeline

    def use(**changes):
        """Serve with another EngineConfig on the same model and weights."""
        e = dataclasses.replace(base_ecfg, **changes)
        p = SynthesisPipeline(bundle.model, cfg, e, bundle.vocos)
        p._packed, p._draft = base_pipe.packed_weights(True)
        bundle.ecfg, bundle.pipeline = e, p

    texts = ["Hello world.",
             "The quick brown fox jumps over the lazy dog. It was a bright cold day in April.",
             "Good morning.",
             "Speech synthesis turns written text into sound."]
    prompts = ["paimon", "fuxuan", None, "alan"]
    loader.reset_launch_counts()
    batch_frames = 0

    def run_batch(label, single_codes=None, require_equal=False, **kw):
        """One generate_audio_batch of the four requests; with single_codes,
        the leading AR frames each row shares with its request alone (all of
        them, or the run fails, with require_equal)."""
        nonlocal batch_frames
        t0 = time.perf_counter()
        waves = api.generate_audio_batch(texts, prompts, language="en", **kw)
        secs = time.perf_counter() - t0
        res = bundle.last
        frames = [len(c) for c, _ in res.outputs]
        for r, (w, n) in enumerate(zip(waves, frames)):
            if not (n > 0 and w.ndim == 1 and len(w) == n * 320 and np.isfinite(w).all()):
                fail(f"{label} request {r}: wave of {len(w)} samples for {n} frames")
        batch_frames += sum(frames)
        audio_s = sum(frames) / 75
        line = (f"  {label}: frames {frames} ({audio_s:.2f} s audio) in {secs:.2f} s,"
                f" aggregate RTF {secs / audio_s:.4f}, AR {res.seconds['ar']:.2f} s / NAR"
                f" {res.seconds['nar']:.2f} s / Vocos {res.seconds.get('vocos', 0):.2f} s,"
                f" {res.ar.iterations} blocks")
        if single_codes is not None:
            lead = []
            for (c, _), s in zip(res.outputs, single_codes):
                n = min(len(c), len(s))
                neq = np.nonzero(c[:n, 0] != s[:n, 0])[0]
                lead.append(int(neq[0]) if len(neq) else n)
            line += f", leading AR frames equal to the request alone: {lead} of {frames}"
            if require_equal and (lead != frames or frames != [len(c) for c in single_codes]):
                fail(f"{label}: batched rows differ from the requests alone: {lead} of {frames}")
        say(line)

    def singles(label, **changes):
        use(**changes)
        return [run(f"{label} alone, request {r}", text=t, prompt=p, language="en", top_k=1)
                for r, (t, p) in enumerate(zip(texts, prompts))]

    with phase("5b generate_audio_batch", 600):
        use()
        run_batch("batch of 4, sampled (top_k=-100)", seed=0)
        greedy_alone = singles("greedy, speculative off", speculative="off")
        use()
        run_batch("batch of 4, greedy (top_k=1)", greedy_alone, top_k=1)
        int8_alone = singles("greedy int8", quantize="int8")
        run_batch("batch of 4, greedy int8", int8_alone, top_k=1)
        use()

    with phase("5c server", 300):
        b = DynamicBatcher(max_batch=4, max_wait_ms=200)
        srv = make_server("127.0.0.1", 0, batcher=b)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        out, errors = {}, []

        def post(i, text):
            body = json.dumps({"text": text, "language": "en", "top_k": 1}).encode()
            try:
                with urllib.request.urlopen(urllib.request.Request(url + "/synthesize", data=body),
                                            timeout=240) as r:
                    out[i] = (r.status, r.read())
            except Exception as exc:  # noqa: BLE001 (reported below, then fail)
                errors.append(f"request {i}: {exc!r}")

        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i, t)) for i, t in
                 enumerate(["Hi.", "Go now.", "Yes, please.", "Thank you."])]
        for t in posts:
            t.start()
        for t in posts:
            t.join(260)
        secs = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            metrics = {k: float(v) for k, v in (ln.split(" ", 1) for ln in r.read().decode().splitlines()
                                                 if ln and not ln.startswith("#"))}
        srv.shutdown()
        srv.server_close()
        b.shutdown()
        th.join(30)
        if errors or sorted(out) != [0, 1, 2, 3]:
            fail(f"5c: answers {sorted(out)}, errors {errors}")
        seconds_audio = 0.0
        for i, (status, body) in sorted(out.items()):
            with wave_mod.open(io.BytesIO(body)) as f:
                if status != 200 or f.getframerate() != 24000 or f.getnframes() == 0:
                    fail(f"5c request {i}: status {status}, {f.getframerate()} Hz, {f.getnframes()} samples")
                seconds_audio += f.getnframes() / 24000
        m = {k: metrics.get(k, 0.0) for k in (
            "vallex_batched_calls_total", "vallex_batch_retries_total",
            "vallex_synth_errors_total", "vallex_decode_calls_total", "vallex_pad_requests_total")}
        say(f"  4 concurrent POST /synthesize: all 200, {seconds_audio:.2f} s audio in {secs:.2f} s"
            f" (aggregate RTF {secs / seconds_audio:.4f}); metrics {json.dumps(m)}")
        if not (m["vallex_batched_calls_total"] >= 1 and m["vallex_batch_retries_total"] == 0
                and m["vallex_synth_errors_total"] == 0):
            fail(f"5c: the requests were not served by a clean batched call: {m}")
    counts_batched = dict(loader.launch_counts)

    # ---- phase 5d: best_of, filtered sampling, long text, 16 rows, f32 -------
    loader.reset_launch_counts()
    with phase("5d best_of / filtered / long text / f32", 600):
        use()
        run("best_of=5, sampled", text="Hello world.", prompt="paimon", language="en",
            best_of=5, seed=0)
        res = bundle.last
        if res.ar.beam_tokens.shape[0] != 5:
            fail(f"best_of=5: {res.ar.beam_tokens.shape[0]} samples")
        say(f"    scores of the 5 samples {np.round(res.ar.scores, 4).tolist()}, best"
            f" {res.ar.best_beam}")
        run("top_k=50, top_p=0.9", text="Hello world.", prompt="paimon", language="en",
            top_k=50, top_p=0.9, seed=0)
        run_batch("batch of 4, best_of=5 (20 rows), sampled", best_of=5, seed=0)
        scores = bundle.last.ar.scores
        if scores.shape != (4, 5):
            fail(f"batch best_of=5: scores {scores.shape}")
        run_batch("batch of 4, top_k=50, top_p=0.9", top_k=50, top_p=0.9, seed=0)

        short = ["Hi.", "Go now.", "Good morning.", "Thank you."]
        more = ["See you.", "Yes.", "No way.", "Come here.", "Well done.", "Good night.",
                "Hello.", "Stop.", "Sit down.", "Okay then.", "Not now.", "Run fast."]
        t0 = time.perf_counter()
        api.generate_audio_batch(short, language="en", top_k=1)
        four = [c for c, _ in bundle.last.outputs]
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        api.generate_audio_batch(short + more, language="en", top_k=1)
        sixteen = [c for c, _ in bundle.last.outputs]
        t16 = time.perf_counter() - t0
        for r in range(4):
            if not np.array_equal(four[r][:, 0], sixteen[r][:, 0]):
                fail(f"batch of 16: AR row {r} differs from the batch of 4")
        nar_equal = sum(int(np.array_equal(a, b)) for a, b in zip(four, sixteen[:4]))
        frames16 = sum(len(c) for c in sixteen)
        say(f"  greedy batch of 16: {frames16} frames ({frames16 / 75:.2f} s audio) in {t16:.2f} s,"
            f" aggregate RTF {t16 / (frames16 / 75):.4f} (the batch of its first 4: {t4:.2f} s);"
            f" AR tokens of rows 0-3 equal to the batch of 4, all 8 codebooks equal in"
            f" {nar_equal} of 4")

        long_text = ("The quick brown fox jumps over the lazy dog. It was a bright cold day"
                     " in April. Speech synthesis turns written text into sound.")
        for mode in ("fixed-prompt", "sliding-window"):
            t0 = time.perf_counter()
            w = api.generate_audio_from_long_text(long_text, "paimon", language="en", mode=mode,
                                                  seed=0)
            secs = time.perf_counter() - t0
            if not (w.ndim == 1 and len(w) > 0 and len(w) % 320 == 0 and np.isfinite(w).all()):
                fail(f"long text {mode}: wave of {len(w)} samples")
            say(f"  long text, {mode}, 3 sentences: {len(w) / 24000:.2f} s audio in {secs:.2f} s,"
                f" RTF {secs / (len(w) / 24000):.4f}")

        b = DynamicBatcher(max_batch=4, max_wait_ms=50)
        srv = make_server("127.0.0.1", 0, batcher=b)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            body = json.dumps({"text": "Hello there. Good morning.", "prompt": "paimon",
                               "language": "en", "seed": 1}).encode()
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(url + "/synthesize-long",
                                                               data=body), timeout=240) as r:
                first_s = None
                chunks = []
                while True:
                    part = r.read1(1 << 16) if hasattr(r, "read1") else r.read()
                    if not part:
                        break
                    first_s = first_s or time.perf_counter() - t0
                    chunks.append(part)
                status, ctype = r.status, r.headers["Content-Type"]
            pcm = np.frombuffer(b"".join(chunks), "<i2")
            if status != 200 or not ctype.startswith("audio/L16") or len(pcm) == 0:
                fail(f"5d /synthesize-long: status {status}, {ctype}, {len(pcm)} samples")
            say(f"  POST /synthesize-long: 200, {len(pcm) / 24000:.2f} s of PCM, first bytes"
                f" after {first_s:.2f} s, all after {time.perf_counter() - t0:.2f} s")
            body = json.dumps({"text": "Hi there.", "language": "en", "best_of": 2}).encode()
            with urllib.request.urlopen(urllib.request.Request(url + "/synthesize", data=body),
                                        timeout=240) as r:
                status, wav = r.status, r.read()
            with wave_mod.open(io.BytesIO(wav)) as f:
                if status != 200 or f.getframerate() != 24000 or f.getnframes() == 0:
                    fail(f"5d best_of=2 POST: status {status}, {f.getnframes()} samples")
                say(f"  POST /synthesize best_of=2: 200, {f.getnframes() / 24000:.2f} s WAV")
            errors = b.metrics.get("vallex_synth_errors_total")
            if errors:
                fail(f"5d server: {errors} synthesis errors")
        finally:
            srv.shutdown()
            srv.server_close()
            b.shutdown()
            th.join(30)

        with tempfile.TemporaryDirectory() as td:
            out_wav = os.path.join(td, "cli.wav")
            t0 = time.perf_counter()
            cli = subprocess.run(
                [sys.executable, "-m", "vallex_tpu_torch.cli", "synthesize", "Hi.",
                 "--random-weights", "--top-k", "1", "-o", out_wav],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            if cli.returncode != 0 or not os.path.exists(out_wav):
                fail(f"5d CLI: rc {cli.returncode}: {cli.stderr[-1500:]}")
            with wave_mod.open(out_wav) as f:
                n = f.getnframes()
            say(f"  python -m vallex_tpu_torch.cli synthesize: rc 0, {n / 24000:.2f} s WAV in"
                f" {time.perf_counter() - t0:.2f} s (a process of its own)")

        # compute_dtype="float32" through the f32 kernels, against the plain
        # path on the CPU (the per-token loop, which never speculates): once
        # with K-step blocks at M = 1, once with the default speculation (an
        # int8 draft over the f32 cache, f32 verify passes of 8 positions)
        req = dict(text="Hello world.", prompt="paimon", language="en", top_k=1,
                   max_duration=0.86)  # a cap of 64 frames
        gpu32 = {}
        for spec in ("off", "auto"):
            e32 = dataclasses.replace(base_ecfg, compute_dtype="float32", speculative=spec)
            api.preload_models(random_weights=True, seed=0, device=dev, ecfg=e32)
            before = loader.launch_counts.get(("gemm_small_m", "decode_verify"), 0)
            t0 = time.perf_counter()
            api.generate_audio(**req)
            gpu32[spec] = (api._bundle.last, time.perf_counter() - t0,
                           loader.launch_counts.get(("gemm_small_m", "decode_verify"), 0) - before)
        if gpu32["auto"][2] == 0 or gpu32["off"][2] != 0:
            fail(f"5d f32: verify products launched {gpu32['off'][2]} times without speculation"
                 f" and {gpu32['auto'][2]} times with it")
        api.preload_models(random_weights=True, seed=0, device="cpu", ecfg=e32)
        api.generate_audio(**req)
        cpu32 = api._bundle.last
        for spec, (res, t_gpu, n_verify) in gpu32.items():
            if not (len(res.codes) == 64 and np.array_equal(res.codes, cpu32.codes)):
                lead = int(np.argmax(np.any(res.codes != cpu32.codes, axis=1))) \
                    if res.codes.shape == cpu32.codes.shape else -1
                fail(f"5d f32, speculative={spec}: codes {res.codes.shape} on the card vs"
                     f" {cpu32.codes.shape} on the CPU, first differing frame {lead}")
            say(f"  f32 greedy request (64 frames), speculative={spec}: codes on the card equal"
                f" the CPU plain path's, all 8 codebooks; {t_gpu:.2f} s on the card,"
                f" {res.ar.iterations} {'verify passes' if spec == 'auto' else 'blocks'},"
                f" {res.ar.accepted_drafts} drafts accepted, {n_verify} f32 verify products")
        # decode_steps = 16: each verify pass sends 16 queries per head to
        # masked_attention. f32 on the card against the CPU plain path (the
        # per-token loop, which never speculates: cpu32 is its reference
        # too), at the 64-frame cap of the f32 checks above
        e16 = dataclasses.replace(base_ecfg, compute_dtype="float32", decode_steps=16)
        api.preload_models(random_weights=True, seed=0, device=dev, ecfg=e16)
        before = loader.launch_counts.get(("masked_attention", "decode_verify"), 0)
        t0 = time.perf_counter()
        api.generate_audio(**req)
        res16, t16 = api._bundle.last, time.perf_counter() - t0
        n16 = loader.launch_counts.get(("masked_attention", "decode_verify"), 0) - before
        if not (n16 > 0 and len(res16.codes) == 64 and np.array_equal(res16.codes, cpu32.codes)):
            fail(f"5d f32 decode_steps=16: codes {res16.codes.shape} on the card vs"
                 f" {cpu32.codes.shape} on the CPU (equal: {np.array_equal(res16.codes, cpu32.codes)}),"
                 f" {n16} verify attention launches")
        say(f"  f32 greedy request (64 frames), decode_steps=16 (speculative): codes on the card"
            f" equal the CPU plain path's, all 8 codebooks; {t16:.2f} s, {res16.ar.iterations}"
            f" verify passes of 16 positions, {res16.ar.accepted_drafts} drafts accepted,"
            f" {n16} verify attention launches")
        api._bundle = bundle
        # ... and in bf16 through the main bundle: greedy and sampled
        use(decode_steps=16)
        run("decode_steps=16, greedy", text="Hello world.", prompt="paimon", language="en",
            top_k=1)
        run("decode_steps=16, sampled", text="Hello world.", prompt="paimon", language="en",
            seed=0)
        use()
    counts_slice3 = dict(loader.launch_counts)

    # ---- phase 5e: int8kv, w8a8, decode_steps=1, decode_mode="pallas" --------
    def serve_four(label):
        """4 concurrent POST /synthesize on a fresh server of the current
        bundle: all answered, coalesced, with no retry and no failure."""
        b = DynamicBatcher(max_batch=4, max_wait_ms=200)
        srv = make_server("127.0.0.1", 0, batcher=b)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/synthesize"
        out, errors = {}, []

        def post(i, text):
            body = json.dumps({"text": text, "language": "en", "top_k": 1}).encode()
            try:
                with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                            timeout=240) as r:
                    out[i] = (r.status, r.read())
            except Exception as exc:  # noqa: BLE001 (reported below, then fail)
                errors.append(f"request {i}: {exc!r}")

        t0 = time.perf_counter()
        try:
            posts = [threading.Thread(target=post, args=(i, t)) for i, t in
                     enumerate(["Hi.", "Go now.", "Yes, please.", "Thank you."])]
            for t in posts:
                t.start()
            for t in posts:
                t.join(260)
            secs = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
            b.shutdown()
            th.join(30)
        m = {k: b.metrics.get(k) for k in ("vallex_batched_calls_total",
                                           "vallex_batch_retries_total",
                                           "vallex_synth_errors_total")}
        if errors or sorted(out) != [0, 1, 2, 3] or any(st != 200 for st, _ in out.values()):
            fail(f"5e {label}: answers {sorted(out)}, errors {errors}")
        if not (m["vallex_batched_calls_total"] >= 1 and m["vallex_batch_retries_total"] == 0
                and m["vallex_synth_errors_total"] == 0):
            fail(f"5e {label}: not a clean batched call: {m}")
        audio_s = 0.0
        for status, body in out.values():
            with wave_mod.open(io.BytesIO(body)) as f:
                audio_s += f.getnframes() / 24000
        say(f"  {label}: 4 concurrent POST /synthesize all 200, {audio_s:.2f} s audio in"
            f" {secs:.2f} s (aggregate RTF {secs / audio_s:.4f}); metrics {json.dumps(m)}")

    loader.reset_launch_counts()
    with phase("5e int8kv / w8a8 / decode_steps=1 / pallas", 600):
        hello = dict(text="Hello world.", prompt="paimon", language="en")
        for q in ("w8a8", "int8kv"):
            use(quantize=q)
            run(f"{q}, greedy", top_k=1, **hello)
            run(f"{q}, sampled", seed=0, **hello)
        run("int8kv, best_of=5, sampled", best_of=5, seed=0, **hello)
        if bundle.last.ar.beam_tokens.shape[0] != 5:
            fail("int8kv best_of=5: not 5 samples")
        w8a8_alone = singles("greedy w8a8", quantize="w8a8")
        run_batch("batch of 4, greedy w8a8", w8a8_alone, require_equal=True, top_k=1)
        use(quantize="int8kv")
        run_batch("batch of 4, greedy int8kv", top_k=1)

        eight = ("Hello there. The sun is up. We walk to town. The shop is open. We buy some"
                 " bread. It is warm. We go home. The day is done.")
        t0 = time.perf_counter()
        w = api.generate_audio_from_long_text(eight, "paimon", language="en", mode="fixed-prompt",
                                              seed=0)
        secs = time.perf_counter() - t0
        n_batch = len(getattr(bundle.last, "outputs", ()))
        if n_batch != 8 or not (w.ndim == 1 and len(w) > 0 and np.isfinite(w).all()):
            fail(f"5e long text int8kv: the last batch held {n_batch} sentences, wave {len(w)}")
        say(f"  long text, fixed-prompt, int8kv, 8 sentences in one batch: {len(w) / 24000:.2f} s"
            f" audio in {secs:.2f} s, RTF {secs / (len(w) / 24000):.4f}")
        serve_four("server with quantize=int8kv")

        with tempfile.TemporaryDirectory() as td:
            out_wav = os.path.join(td, "cli.wav")
            t0 = time.perf_counter()
            cli = subprocess.run(
                [sys.executable, "-m", "vallex_tpu_torch.cli", "synthesize", "Hi.",
                 "--random-weights", "--top-k", "1", "--quantize", "w8a8", "-o", out_wav],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            if cli.returncode != 0 or not os.path.exists(out_wav):
                fail(f"5e CLI --quantize w8a8: rc {cli.returncode}: {cli.stderr[-1500:]}")
            with wave_mod.open(out_wav) as f:
                n = f.getnframes()
            say(f"  python -m vallex_tpu_torch.cli synthesize --quantize w8a8: rc 0,"
                f" {n / 24000:.2f} s WAV in {time.perf_counter() - t0:.2f} s")

        use(decode_steps=1)
        run("decode_steps=1, greedy", top_k=1, **hello)
        run("decode_steps=1, sampled", seed=0, **hello)
        run("decode_steps=1, top_k=50, top_p=0.9", top_k=50, top_p=0.9, seed=0, **hello)
        use(decode_mode="pallas")
        run('decode_mode="pallas", greedy', top_k=1, **hello)

        # f32 greedy requests of 64 frames through the single steps and
        # through "pallas", against the plain path on the CPU
        req = dict(top_k=1, max_duration=0.86, **hello)
        gpu32 = {}
        for name, change in (("decode_steps=1", dict(decode_steps=1)),
                             ('decode_mode="pallas"', dict(decode_mode="pallas"))):
            e32 = dataclasses.replace(base_ecfg, compute_dtype="float32", **change)
            api.preload_models(random_weights=True, seed=0, device=dev, ecfg=e32)
            t0 = time.perf_counter()
            api.generate_audio(**req)
            gpu32[name] = (api._bundle.last, time.perf_counter() - t0)
        api.preload_models(random_weights=True, seed=0, device="cpu",
                           ecfg=dataclasses.replace(base_ecfg, compute_dtype="float32"))
        api.generate_audio(**req)
        cpu32 = api._bundle.last
        for name, (res, t_gpu) in gpu32.items():
            if not (len(res.codes) == 64 and np.array_equal(res.codes, cpu32.codes)):
                fail(f"5e f32, {name}: codes {res.codes.shape} on the card vs"
                     f" {cpu32.codes.shape} on the CPU")
            say(f"  f32 greedy request (64 frames), {name}: codes on the card equal the CPU"
                f" plain path's, all 8 codebooks; {t_gpu:.2f} s on the card,"
                f" {res.ar.iterations} steps")
        api._bundle = bundle
        use()
    counts_slice4 = dict(loader.launch_counts)

    # ---- phase 5f: training --------------------------------------------------
    loader.reset_launch_counts()
    with phase("5f training", 300):
        train_path(dev, cfg)
    counts_slice5 = dict(loader.launch_counts)

    with phase("7 trace", 300):
        def one_request():
            api.generate_audio("Hello world.", prompt="paimon", language="en", top_k=1,
                               max_duration=3.0)
            return bundle.last.seconds, len(bundle.last.codes)

        short = ["Hi.", "Go now.", "Good morning.", "Thank you."]

        def one_batch():
            api.generate_audio_batch(short, language="en", top_k=1)
            return bundle.last.seconds, [len(c) for c, _ in bundle.last.outputs]

        trace_run("'Hello world.', paimon, top_k=1, max_duration 3 s", one_request)
        trace_run(f"generate_audio_batch {short}, no prompt, top_k=1", one_batch)

    with phase("8 kernels line", 30):
        for site, counts in (("flash_attention", counts_single),
                             ("flash_attention_batched", counts_batched)):
            if counts.get(("masked_attention", site), 0):
                fail(f"masked_attention launched at the NAR's site {site}")
        for e in entries:
            kernel, site = e["name"].split("@")
            if site.endswith(HD128):
                e["launches"] = counts_hd128.get((kernel, site[:-len(HD128)]), 0)
                if e["launches"] == 0:
                    fail(f"{e['name']}: no launch at head dim 128")
                continue
            counts = (counts_batched if site in BATCHED_SITES
                      else counts_slice3 if site in SLICE3_SITES
                      else counts_slice4 if site in SLICE4_SITES
                      else counts_slice5 if site in SLICE5_SITES else counts_single)
            e["launches"] = counts.get((kernel, site), 0)
            if e["launches"] == 0:
                fail(f"{e['name']}: no launch on the main path")
        extra = {f"{k}@{s}": n for (k, s), n in {**counts_single, **counts_batched}.items()
                 if s not in TPU}
        say(f"  launches outside the TPU-kernel sites: {extra}; frames: single-request path"
            f" {frames_single}, batched path {batch_frames}")
        say(f"  phase 5d launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice3.items())})}")
        say(f"  phase 5e launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice4.items())})}")
        say(f"  phase 5f launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice5.items())})}")
        say(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "unit"} for e in entries]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
