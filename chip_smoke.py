"""Smoke run of vallex_tpu_torch on one NVIDIA GPU (H100): builds the
hand-written kernels, holds each against its plain PyTorch version at full
width, then drives the port's entry points at the shipped width (random
weights from a seed) and shows that each path went through the kernels.

    python3 chip_smoke.py

Phases, one flushed line each with its own seconds and wall-clock limit:
  1  card name and power limit (nvidia-smi)
  2  kernel build (nvcc, from the sources in the checkout)
  3  each kernel against its plain version, at each single-request site
  3b the same at the batched sites: decode attention with per-row bounds
     (B = 4), the NAR attention at B = 4, the products of one batched step
     at M = 4 and 8 (bf16 and int8, each row equal to its M = 1 product),
     sampling over 8 rows
  4  the ports of decode_block_fused (int8, K-1 = 7) and decode_verify
     (bf16, K = 8) against the same ops on the CPU (the plain versions)
  4b the batched decode_block_fused (K = 8, B = 4, bf16 and int8) against
     each row run alone from the same prefilled caches
  5  generate_audio twice (default sampled mode; top_k=1)
  6  generate_audio with s_text + t_audio >= 1536 (the NAR attention kernel)
  5b generate_audio_batch of 4 requests: sampled, greedy, greedy int8; one
     single-request int8 generate_audio; greedy rows against single runs
  5c the HTTP server: 4 concurrent POST /synthesize coalesced by the
     DynamicBatcher into a batched call
  7  torch.profiler traces of one request and of one batch of 4: the
     device-busy share of their AR, NAR and Vocos spans, and the AR's
     device time by kernel
  8  the `kernels` JSON line, then the result line.
Launch counts are zeroed just before phase 5 and read after phase 6 (the
single-request path), and zeroed again just before phase 5b and read after
phase 5c (the batched path). Any failure exits non-zero before the result
line. No JAX is imported.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
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

REPO = os.path.dirname(os.path.abspath(__file__))
TPU = {  # TPU kernel each main-path site stands for (file:line of the function)
    "decode_block_fused": "vallex_tpu/ops/decode_block.py:1329",
    "decode_verify": "vallex_tpu/ops/decode_verify.py:368",
    "flash_attention": "vallex_tpu/models/layers.py:205",
    # decode_block_fused(batched=True): its batched fold _hbm_fold_batched
    "decode_block_fused_batched": "vallex_tpu/ops/decode_block.py:828",
    "flash_attention_batched": "vallex_tpu/models/layers.py:205",
}
BATCHED_SITES = ("decode_block_fused_batched", "flash_attention_batched")


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
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
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
    say("trace " + json.dumps(out))


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
    from vallex_tpu_torch.kernels.masked_attention import attention_bounds, valid_keys
    from vallex_tpu_torch.ops.decode_block import decode_block_fused
    from vallex_tpu_torch.ops.decode_verify import decode_verify
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
        report = lib.parent / ("ptxas_" + lib.name.split("_")[-1].split(".")[0] + ".txt")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Used" in line and "registers" in line:
                    say("  ptxas: " + line.split("ptxas info    :")[-1].strip())
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

    def entry(kernel, site, err, ms, plain_ms, bytes_, ops, library_ms, unit, in_line=True):
        """One measured row; rows with in_line=False are variants printed
        beside their site's row but kept out of the `kernels` line, which
        has one entry per (kernel, site) launch counter."""
        bound_b, bound_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        if in_line:
            entries.append(dict(
                name=f"{kernel}@{site}", route="cuda",
                source=f"vallex_tpu_torch/kernels/{kernel}.cu", replaces=TPU[site],
                launches=0, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_b, bound_o),
                bound_by="bytes" if bound_b >= bound_o else "operations",
                library_ms=library_ms, unit=unit))
        say(f"  {kernel}@{site}: max_abs_err {err:.3e}  {ms:.4f} ms  plain {plain_ms:.4f} ms"
            f"  bound {max(bound_b, bound_o):.4f} ms  library "
            f"{'null' if library_ms is None else f'{library_ms:.4f} ms'}  ({unit})")

    # ---- kernel checks -------------------------------------------------------
    def gemm_calls(lw, M):
        x_d = torch.randn((M, D), generator=g, device=dev)
        x_f = torch.relu(torch.randn((M, F), generator=g, device=dev))
        calls = []
        for li in range(NL):
            sc = (lambda n: None if lw[n] is None else lw[n][li])
            calls += [
                (x_d, lw["wqkv"][li], dict(scale=sc("sqkv"), bias=lw["bqkv"][li],
                                           ln=(lw["ln1s"][li], lw["ln1b"][li]))),
                (x_d, lw["wout"][li], dict(scale=sc("sout"), bias=lw["bout"][li], residual=x_d)),
                (x_d, lw["w1"][li], dict(scale=sc("s1"), bias=lw["b1"][li],
                                         ln=(lw["ln2s"][li], lw["ln2b"][li]), relu=True)),
                (x_f, lw["w2"][li], dict(scale=sc("s2"), bias=lw["b2"][li], residual=x_d)),
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

    def check_gemm(site, lw, M, unit, in_line=True):
        calls = gemm_calls(lw, M)
        err = 0.0
        for x, w, kw in calls:
            yk = gemm_small_m(x, w, site="check", **kw)
            yp = gemm_small_m_plain(x, w, **kw)
            torch.cuda.synchronize()
            scale = max(1.0, float(yp.abs().max()))
            e = float((yk - yp).abs().max())
            # activations are rounded to bf16 after an f32 LayerNorm on
            # both sides; one rounding flip moves a sum by ~1e-3 of its scale
            if not e <= 1e-2 * scale:
                fail(f"gemm_small_m@{site}: err {e} at scale {scale} for w {tuple(w.shape)}")
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
        if lw["sqkv"] is None:  # bf16: one F.linear per product
            xs = [(x.to(torch.bfloat16), w, kw.get("bias")) for x, w, kw in calls]
            lib_ms = device_ms(lambda: [Fn.linear(x, w, b if b is None else b.to(torch.bfloat16)) for x, w, b in xs])
        else:  # int8 W8A16: one _weight_int8pack_mm per product
            lib_ms = int8_library_ms(calls)
        nbytes = sum(w.numel() * w.element_size() + 4 * (M * (w.shape[0] + w.shape[1]))
                     + (0 if kw.get("scale") is None else 4 * w.shape[0]) for x, w, kw in calls)
        ops = sum(2 * M * w.shape[0] * w.shape[1] for _, w, _ in calls)
        entry("gemm_small_m", site, err, ms, pms, nbytes, ops, lib_ms,
              f"{unit}: {len(calls)} products, M={M}, "
              f"{'int8' if lw['sqkv'] is not None else 'bf16'} weights", in_line)

    def check_attention(site, q, k, v, bounds, reps_layers, io):
        B, _, Tq, _ = q.shape
        outk = masked_attention(q, k, v, bounds, site="check").float()
        # the plain version in f32 on the same (bf16-valued) inputs
        ref = masked_attention_plain(q.float(), k, v, bounds)
        torch.cuda.synchronize()
        diff = (outk - ref).abs()
        err = float(diff.max())
        if io == "f32":
            # f32 softmax and sums on both sides, in another order
            tol = torch.full_like(ref, 2e-5)
        else:
            # bf16 output: the kernel rounds its f32 result once, so each
            # element lies within one bf16 ulp of the f32 reference, plus
            # 1e-5 of max|ref| for elements near zero, where the f32 sums'
            # order and the fast exp show. One key taken or missed moves
            # elements by ~|v|/n_keys, several ulps at this scale.
            ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -100))) - 7)
            tol = ulp + 1e-5 * float(ref.abs().max())
        if not bool((diff <= tol).all()):
            i = int((diff - tol).argmax())
            fail(f"masked_attention@{site}: err {float(diff.flatten()[i])} > "
                 f"{float(tol.flatten()[i])} at |ref| {float(ref.abs().flatten()[i])}")
        ok = valid_keys(Tq, k.shape[2], bounds)  # [B, Tq, C]
        nkeys = int(ok.sum())
        ms = device_ms(lambda: [masked_attention(q, k, v, bounds, site="check")
                                for _ in range(reps_layers)])
        pms = device_ms(lambda: [masked_attention_plain(q, k, v, bounds)
                                 for _ in range(reps_layers)])
        qb, mask = q.to(torch.bfloat16), ok[:, None]  # per-row boolean mask [B, 1, Tq, C]
        lib_ms = device_ms(lambda: [Fn.scaled_dot_product_attention(qb, k, v, attn_mask=mask)
                                    for _ in range(reps_layers)])
        rows = int(ok.any(1).sum())  # valid key rows, summed over the batch rows
        nbytes = reps_layers * (2 * rows * H * hd * 2 + 2 * B * Tq * H * hd * q.element_size())
        ops = reps_layers * 4 * nkeys * hd * H
        entry("masked_attention", site, err, ms, pms, nbytes, ops, lib_ms,
              f"{reps_layers} launch(es): B={B}, Tq={Tq}, {rows} valid key rows of "
              f"{B} x {k.shape[2]}, {io} q/out")

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
                        one, NL, "f32")
        check_attention("decode_verify", decode_q(1, 8), cache_k[0][None], cache_v[0][None],
                        one, NL, "f32")
        T_NAR, S_NAR = 2304, 256
        qn, kn, vn = (torch.randn((1, H, T_NAR, hd), generator=g, device=dev).to(torch.bfloat16)
                      for _ in range(3))
        check_attention("flash_attention", qn, kn, vn,
                        attention_bounds(1, x_len=150, s_text=S_NAR, audio_len=1058, q_off=0,
                                         device=dev), 1, "bf16")
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
        check_attention("decode_block_fused_batched", decode_q(B, 1), kb, vb, bb, NL, "f32")
        qn, kn, vn = (torch.randn((B, H, T_NAR, hd), generator=g, device=dev).to(torch.bfloat16)
                      for _ in range(3))
        check_attention("flash_attention_batched", qn, kn, vn,
                        attention_bounds(B, x_len=rows_i32([20, 52, 150, 256]), s_text=S_NAR,
                                         audio_len=rows_i32([832, 892, 1158, 2046]), q_off=0,
                                         device=dev), 1, "bf16")
        check_gemm("decode_block_fused_batched", packed, 4, "one batched step")
        check_gemm("decode_block_fused_batched", packed, 8, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", draft, 4, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", draft, 8, "one batched step", in_line=False)
        check_sample("decode_block_fused_batched", 8, False)

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

    def run_batch(label, single_codes=None, **kw):
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
        for e in entries:
            kernel, site = e["name"].split("@")
            counts = counts_batched if site in BATCHED_SITES else counts_single
            e["launches"] = counts.get((kernel, site), 0)
            if e["launches"] == 0:
                fail(f"{e['name']}: no launch on the main path")
        extra = {f"{k}@{s}": n for (k, s), n in {**counts_single, **counts_batched}.items()
                 if s not in TPU}
        say(f"  launches outside the TPU-kernel sites: {extra}; frames: single-request path"
            f" {frames_single}, batched path {batch_frames}")
        say(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "unit"} for e in entries]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
