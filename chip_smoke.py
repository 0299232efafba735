"""Smoke run of vallex_tpu_torch on one NVIDIA GPU (H100): builds the
hand-written kernels, holds each against its plain PyTorch version at full
width, then drives `api.generate_audio` at the shipped width (random
weights from a seed) and shows that the main path went through the kernels.

    python3 chip_smoke.py

Phases, one flushed line each with its own seconds and wall-clock limit:
  1 card name and power limit (nvidia-smi)
  2 kernel build (nvcc, from the sources in the checkout)
  3 each kernel against its plain version, at each main-path site
  4 the ports of decode_block_fused (int8, K-1 = 7) and decode_verify
    (bf16, K = 8) against the same ops on the CPU (the plain versions)
  5 generate_audio twice (default sampled mode; top_k=1)
  6 generate_audio with s_text + t_audio >= 1536 (the NAR attention kernel)
  7 a torch.profiler trace of one request: the device-busy share of its
    AR, NAR and Vocos spans, and the AR's device time by kernel
  8 the `kernels` JSON line, then the result line.
Launch counts are zeroed just before phase 5 and read after phase 6. Any
failure exits non-zero before the result line. No JAX is imported.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak (data sheet)

REPO = os.path.dirname(os.path.abspath(__file__))
TPU = {  # TPU kernel each main-path site stands for (file:line of the function)
    "decode_block_fused": "vallex_tpu/ops/decode_block.py:1329",
    "decode_verify": "vallex_tpu/ops/decode_verify.py:368",
    "flash_attention": "vallex_tpu/models/layers.py:205",
}


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


def trace_request(api, bundle) -> None:
    """Run one greedy request plainly (twice) and under torch.profiler, and
    report for each pipeline span the share of its wall time in which the
    card ran a kernel or a copy. Kernel times do not depend on the profiler;
    the host does more under it, so the share is also given against the
    unprofiled span's host-clock seconds."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(text="Hello world.", prompt="paimon", language="en", top_k=1, max_duration=3.0)
    plain_s = {}
    for _ in range(2):  # the faster of two unprofiled runs
        api.generate_audio(**kw)
        for k, v in bundle.last.seconds.items():
            plain_s[k] = min(v, plain_s.get(k, v))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.generate_audio(**kw)
    frames = len(bundle.last.codes)
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
    out = {"request": f"{kw['text']!r}, {kw['prompt']}, top_k=1, {frames} frames"}
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
    from vallex_tpu_torch.kernels import (
        gemm_small_m, gemm_small_m_plain, loader, masked_attention,
        masked_attention_plain, sample_epilogue, sample_epilogue_plain,
    )
    from vallex_tpu_torch.kernels.masked_attention import valid_keys
    from vallex_tpu_torch.ops.decode_block import decode_block_fused
    from vallex_tpu_torch.ops.decode_verify import decode_verify

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

    def entry(kernel, site, err, ms, plain_ms, bytes_, ops, library_ms, unit):
        bound_b, bound_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
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

    # ---- phase 3: every kernel against its plain version ---------------------
    with phase("3 kernels vs plain", 240):
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

        def check_gemm(site, lw, M):
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
                  f"one {'draft step' if M == 1 else 'verify pass'}: {len(calls)} products, M={M}, "
                  f"{'int8' if lw['sqkv'] is not None else 'bf16'} weights")

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

        check_gemm("decode_block_fused", draft, 1)
        check_gemm("decode_verify", packed, 8)

        def check_attention(site, q, k, v, kw, reps_layers, io):
            outk = masked_attention(q, k, v, site="check", **kw).float()
            # the plain version in f32 on the same (bf16-valued) inputs
            ref = masked_attention_plain(q.float(), k, v, **kw)
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
            Tq = q.shape[2]
            ok = valid_keys(Tq, k.shape[2], kw["x_len"], kw["s_text"], kw["audio_len"],
                            kw["q_off"], dev)
            nkeys = int(ok.sum())
            ms = device_ms(lambda: [masked_attention(q, k, v, site="check", **kw)
                                    for _ in range(reps_layers)])
            pms = device_ms(lambda: [masked_attention_plain(q, k, v, **kw)
                                     for _ in range(reps_layers)])
            qb, kb, vb = q.to(torch.bfloat16), k, v
            lib_ms = device_ms(lambda: [Fn.scaled_dot_product_attention(qb, kb, vb, attn_mask=ok)
                                        for _ in range(reps_layers)])
            rows = int(ok.any(0).sum())
            nbytes = reps_layers * (2 * rows * H * hd * 2 + 2 * Tq * H * hd * q.element_size())
            ops = reps_layers * 4 * nkeys * hd * H
            entry("masked_attention", site, err, ms, pms, nbytes, ops, lib_ms,
                  f"{reps_layers} launch(es): Tq={Tq}, {rows} valid keys of {k.shape[2]}, {io} q/out")

        def decode_q(M):
            qkv = torch.randn((M, 3 * D), generator=g, device=dev)
            return qkv[:, :D].view(M, H, hd).transpose(0, 1)[None]

        akw = dict(x_len=X_LEN, s_text=S_TEXT, audio_len=POS0 + 1, q_off=1)
        check_attention("decode_block_fused", decode_q(1), cache_k[0][None], cache_v[0][None],
                        akw, NL, "f32")
        check_attention("decode_verify", decode_q(8), cache_k[0][None], cache_v[0][None],
                        akw, NL, "f32")
        T_NAR, S_NAR = 2304, 256
        qn, kn, vn = (torch.randn((1, H, T_NAR, hd), generator=g, device=dev).to(torch.bfloat16)
                      for _ in range(3))
        check_attention("flash_attention", qn, kn, vn,
                        dict(x_len=150, s_text=S_NAR, audio_len=1058, q_off=0), 1, "bf16")

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
            entry("sample_epilogue", site, err, ms, pms, nbytes, 4 * rows * VP, None,
                  f"1 launch: {rows} x {VP} logits, {'greedy' if greedy else 'Gumbel'}")

        check_sample("decode_block_fused", 1, False)
        check_sample("decode_verify", 8, True)

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

    # ---- phases 5 and 6: the main path ---------------------------------------
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
            f" {res.seconds.get('vocos', 0):.2f} s, {res.ar.iterations} verify passes,"
            f" {res.ar.accepted_drafts / it:.2f} accepted drafts per pass")

    with phase("5 generate_audio", 300):
        run("sampled (top_k=-100)", text="Hello world.", prompt="paimon", language="en", seed=0)
        run("greedy (top_k=1)", text="Hello world.", prompt="paimon", language="en", top_k=1)
    with phase("6 generate_audio, NAR >= 1536", 300):
        run("long prompt, max_duration 4 s", text="The quick brown fox jumps over the lazy dog.",
            prompt="fuxuan", language="en", max_duration=4.0, seed=1)
    counts = dict(loader.launch_counts)

    with phase("7 trace", 240):
        trace_request(api, bundle)

    with phase("8 kernels line", 30):
        for e in entries:
            kernel, site = e["name"].split("@")
            e["launches"] = counts.get((kernel, site), 0)
            if e["launches"] == 0:
                fail(f"{e['name']}: no launch on the main path")
        extra = {f"{k}@{s}": n for (k, s), n in counts.items() if s not in TPU}
        say(f"  main-path launches outside the TPU-kernel sites: {extra}; frames {frames_total}")
        say(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "unit"} for e in entries]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
