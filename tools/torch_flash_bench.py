"""The port's flash-attention, decode-product, decode-attention and sampling
kernels on one GPU, alone: build, check and time.

    python3 tools/torch_flash_bench.py [--root DIR] [--label NAME] [--hd 64,128]
                                       [--parts flash,gemm,decode,sample,trace,sweep]

Part "flash" runs the checks and timings of chip_smoke.py's phases 3e / 3f
(the forward, dQ and dK/dV kernels against their plain versions at B = 4,
T = 1152, H = 1024 / hd: bf16 and f32, padded and packed rows, prefix T / 0
/ 128, a ragged T = 1100, fused-QKV views; two backward runs bitwise equal;
the backward of both dtypes timed at prefix 128 and T against SDPA's)
and of phases 3 / 3b (the NAR's forward at T = 2304, B = 1 and 4, and the
f32 NAR at B = 1) for each head dim. Part "gemm" builds the shipped model
(random weights, seed 0) and runs phase 3's and 3c's product checks and
timings: the int8 draft step at M = 1 (row a), the bf16 verify pass at
M = 8 (row d) and both in f32 (rows a32, d32), then the f32 step's device
time by kernel under torch.profiler (`breakdown {...}`: the products, the
prep kernels, and the sum of kernel times against the step's span). Part
"decode" runs the decode attention (masked_attention) at the shapes of
phases 3-3d and 3f, PERF.md's rows b, b32, b128, e, e16 (Tq 16), e32, e128,
i, m, n, p, q and s: each against its plain version at 2e-5, two runs
bitwise equal, timed against the plain version and SDPA; the kernel's
instances (shared memory, threads, resident clusters) where the tree has
them. Part "sample" runs the sampling epilogue's checks of phases 3-3d
(PERF.md's rows c, f, j, v and the filtered rows: l, the other settings, 20
rows, top-p alone (l-p), top-k alone, k = 200, ties at the k-th value,
temperature 0.7, 8 rows): tokens equal to the plain version's, logprobs at
1e-4, kept sets equal but at the nucleus boundary, two runs bitwise equal;
after the empty-launch floor (`empty launch ms {...}`). Part "trace" builds
the shipped model and traces one filtered request (`trace {...}`, with the
epilogue's device ms in the AR span). Part "sweep" times the NAR's
two attention routes against each other at each `--hd` (`nar_sweep`: the
crossover that engine/nar.py::flash_route rests on). Each timed row prints as one
JSON line (`row {...}`: kernel, site, ms, plain_ms, bound_ms, bound_by,
library_ms, max_abs_err, unit), after the card's name and power limit and
the flash and product kernels' ptxas lines.

--root imports and builds `vallex_tpu_torch` from another tree (a commit
unpacked with `git archive`), so two commits compare on one card in one
call: run parent, change, change, parent. Needs one CUDA card; exits 1
without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def breakdown(cs, label, fn) -> None:
    """Device ms of fn() by kernel name and grid under torch.profiler, and
    the span from the first kernel's start to the last one's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in cs.trace_events(prof) if e.get("cat") == "kernel" and "dur" in e]
    if not events:
        cs.say(f"breakdown {json.dumps({'label': label, 'kernels': 'not measured'})}")
        return
    by = {}
    for e in events:
        name = e["name"].replace("void ", "").split("(")[0].split("<")[0]
        name += " grid " + "x".join(str(x) for x in e.get("args", {}).get("grid", []))
        n, t = by.get(name, (0, 0.0))
        by[name] = (n + 1, t + float(e["dur"]) / 1e3)
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events)) / 1e3
    cs.say("breakdown " + json.dumps({
        "label": label, "span_ms": round(span, 4),
        "kernel_ms": round(sum(t for _, t in by.values()), 4),
        "by_kernel": {k: {"launches": n, "ms": round(t, 4)} for k, (n, t) in by.items()}}))


# the sweep's lengths C = s_text + t_audio: the offline cells' bucket is
# 256 + 1024 = 1280, the CPU's flash threshold 1536
SWEEP_C = (128, 256, 512, 768, 1024, 1280, 1536)


def nar_sweep(cs, dev, label: str, hds=(64,)) -> None:
    """The NAR's two attention routes on the card, as nar_generate calls
    each: the flash forward (segments (ok, ok), prefix C) and the masked
    core (`attention_core` under the additive key-padding mask), on q/k/v
    views of one fused QKV product, 1024 wide in heads of each of `hds`,
    at C in SWEEP_C, R in 1 and 48 rows, bf16 and f32. The key-padding
    layout is the cells': text s_text = C / 5 columns, 32-100% of them
    valid, and t_audio - 2 valid audio slots. One `sweep {...}` line each: device ms (median of 20, CUDA
    events), the core's over the forward's, and the device bytes each call
    allocates beyond its inputs (`max_memory_allocated`)."""
    import torch

    from vallex_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from vallex_tpu_torch.models.layers import attention_core
    from vallex_tpu_torch.models.vallex import NEG_INF

    def extra_bytes(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    g = torch.Generator().manual_seed(5)
    for hd, dtype in ((hd, dt) for hd in hds for dt in (torch.bfloat16, torch.float32)):
        H = 1024 // hd
        D = H * hd
        for R in (1, 48):
            for C in SWEEP_C:
                s_text = C // 5
                x_len = torch.randint(max(1, int(0.32 * s_text)), s_text + 1, (R, 1), generator=g)
                cols = torch.arange(C)[None, :]
                ok = torch.where(cols < s_text, cols < x_len, cols - s_text < C - s_text - 2)
                ok = ok.to(dev)
                seg = ok.to(torch.int32).contiguous()
                mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
                qkv = torch.randn((R, C, 3 * D), device=dev).to(dtype)
                q, k, v = (qkv[..., i * D:(i + 1) * D].view(R, C, H, hd).transpose(1, 2)
                           for i in range(3))

                def flash():
                    return flash_attention_fwd(q, k, v, seg, seg, C, site="check")[0]

                def core():
                    return attention_core(q, k, v, mask)

                f_ms, c_ms = cs.device_ms(flash), cs.device_ms(core)
                cs.say("sweep " + json.dumps(dict(
                    label=label, hd=hd, dtype=str(dtype)[6:], R=R, C=C, s_text=s_text,
                    valid=int(ok.sum()), flash_ms=round(f_ms, 4), core_ms=round(c_ms, 4),
                    core_over_flash=round(c_ms / f_ms, 3), flash_bytes=extra_bytes(flash),
                    core_bytes=extra_bytes(core))))
                del qkv, q, k, v
                torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="tree whose vallex_tpu_torch is built and timed")
    ap.add_argument("--label", default="", help="name printed on every row")
    ap.add_argument("--hd", default="64,128", help="head dims to run (H = 1024 / hd)")
    ap.add_argument("--parts", default="flash",
                    help="comma-separated: flash, gemm, decode, sample, trace, sweep")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("FAIL no CUDA device: this benchmark runs on the GPU", file=sys.stderr)
        sys.exit(1)
    # this tree's chip_smoke.py (its checks), whatever tree the port comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vallex_tpu_torch.kernels import loader

    import vallex_tpu_torch
    if not os.path.abspath(vallex_tpu_torch.__file__).startswith(root):
        cs.fail(f"imported {vallex_tpu_torch.__file__}, not the tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    cs.say(f"{args.label} card: {smi.splitlines()[0] if smi else 'nvidia-smi gave nothing'};"
           f" tree {root}")
    lib = loader.build()
    report = lib.parent / ("ptxas_" + lib.name.split("_")[-1].split(".")[0] + ".txt")
    if report.exists():
        for blk in report.read_text().split("Compiling entry function")[1:]:
            head = blk.split("\n")[0]
            if any(w in head for w in ("flash_", "gemm_ffma", "masked_attention", "sample_epilogue")):
                said = [ln.split(":", 1)[-1].strip() for ln in blk.splitlines()[1:]
                        if any(w in ln for w in ("spill", "Used"))]
                cs.say(f"  ptxas {head.split(chr(39))[1][:48]}: " + "; ".join(said))
    loader.library()

    def entry(kernel, site, err, ms, plain_ms, bytes_, ops, library_ms, unit, in_line=True,
              ops_per_s=cs.BF16_OPS_PER_S):
        bound_b, bound_o = bytes_ / cs.HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
        cs.say("row " + json.dumps(dict(
            label=args.label, kernel=kernel, site=site, ms=round(ms, 4),
            plain_ms=round(plain_ms, 4), bound_ms=round(max(bound_b, bound_o), 4),
            bound_by="bytes" if bound_b >= bound_o else "operations",
            library_ms=None if library_ms is None else round(library_ms, 4),
            max_abs_err=float(err), unit=unit)))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    parts = args.parts.split(",")
    if "gemm" in parts:
        from vallex_tpu_torch import api
        from vallex_tpu_torch.ops.decode_step import pack_layer_weights

        bundle = api.preload_models(random_weights=True, seed=0, device=dev)
        vocab = bundle.cfg.num_audio_tokens + 1
        packed, draft = bundle.pipeline.packed_weights(True)
        packed32 = pack_layer_weights(bundle.model, torch.float32)
        for site, lw, M, unit in (("decode_block_fused", draft, 1, "one draft step"),
                                  ("decode_verify", packed, 8, "one verify pass"),
                                  ("decode_block_fused", packed32, 1, "one f32 step"),
                                  ("decode_verify", packed32, 8, "one f32 verify pass")):
            cs.check_gemm_products(entry, g, vocab, site, lw, M, unit)
        from vallex_tpu_torch.kernels import gemm_small_m

        for M in (1, 8):
            calls = cs.gemm_calls(packed32, M, g)
            breakdown(cs, f"{args.label} f32 step M={M}",
                      lambda: [gemm_small_m(x, w, site="check", **kw) for x, w, kw in calls])
        del bundle, packed, draft, packed32
        torch.cuda.empty_cache()
    if "decode" in parts:
        from vallex_tpu_torch.kernels import masked_attention as MA

        if hasattr(MA, "kernel_info"):
            for dt in (torch.bfloat16, torch.float32, torch.int8):
                for hd in (64, 128):
                    for Tq in (1, 8, 16):
                        cs.say(f"  masked_attention {dt} hd {hd} Tq {Tq}: "
                               f"{json.dumps(MA.kernel_info(dt, hd, Tq))}")
        cs.decode_attention_rows(entry, g, dev)
        torch.cuda.empty_cache()
    if "sample" in parts:
        from vallex_tpu_torch.config import ModelConfig
        from vallex_tpu_torch.ops.decode_step import VOCAB_PAD

        vocab = ModelConfig().num_audio_tokens + 1
        VP = -(-vocab // VOCAB_PAD) * VOCAB_PAD
        cs.say(f"{args.label} empty launch ms "
               + json.dumps({k: round(v, 4) for k, v in cs.empty_launch_ms(dev).items()}))
        for site, rows, greedy in (("decode_block_fused", 1, False), ("decode_verify", 8, True),
                                   ("decode_block_fused_batched", 8, False),
                                   ("decode_step_fused", 1, False)):
            cs.check_sample_epilogue(entry, g, dev, vocab, VP, site, rows, greedy)
        cs.filtered_rows(entry, g, dev, vocab, VP)
    if "trace" in parts:
        from vallex_tpu_torch import api

        bundle = api.preload_models(random_weights=True, seed=0, device=dev)
        cs.trace_run(f"{args.label} 'Hello world.', paimon, top_k=50, top_p=0.9",
                     lambda: cs.filtered_request(api, bundle))
        del bundle
        torch.cuda.empty_cache()
    if "sweep" in parts:
        nar_sweep(cs, dev, args.label, [int(x) for x in args.hd.split(",")])
    for hd in (int(x) for x in args.hd.split(",")) if "flash" in parts else ():
        H, suffix = 1024 // hd, "" if hd == 64 else "_hd128"
        cs.check_flash_nar(dev, entry, g, "flash_attention" + suffix, [150], [1058], 256, 2304,
                           H=H, hd=hd)
        cs.check_flash_nar(dev, entry, g, "flash_attention" + suffix, [150], [1058], 256, 2304,
                           H=H, hd=hd, dtype=torch.float32)
        cs.check_flash_nar(dev, entry, g, "flash_attention_batched" + suffix,
                           [20, 52, 150, 256], [832, 892, 1158, 2046], 256, 2304, H=H, hd=hd)
        cs.train_kernel_checks(dev, entry, g, H=H, hd=hd, suffix=suffix)
        torch.cuda.empty_cache()
    cs.say(f"{args.label} ok")


if __name__ == "__main__":
    main()
