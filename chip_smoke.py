"""Smoke run of vallex_tpu_torch on one NVIDIA GPU (H100): builds the
hand-written kernels, holds each against its plain PyTorch version at full
width, then drives the port's entry points at the shipped width (random
weights from a seed) and shows that each path went through the kernels.
Phases 3-6, 3f, 5f, 5i's training ranks and 7 run the shipped depth (12
layers a stack); 5b-5i drive the other entry points on a model of the
shipped width cut to LATER_LAYERS (4) layers a stack, so that the whole run
stays well inside its time limit.

    python3 chip_smoke.py

Phases, one flushed line each with its own seconds and wall-clock limit:
  1  card name and power limit (nvidia-smi)
  2  kernel build (nvcc, from the sources in the checkout); the decode
     attention's instances (k/v type x head dim x queries a group): their
     registers, shared memory and spills (a spill fails), dynamic shared
     memory, threads and resident clusters (none fails), and no old
     one-block-per-query kernel left; the bf16 flash
     kernels' (forward, dQ, dK/dV, each at head dim 64 and 128) registers,
     shared memory and spills (ptxas; a spill fails) and their tensor-core
     instructions (HGMMA in the SASS, cuobjdump; none fails); a CUDA-core
     flash kernel built for bf16 fails; the f32 flash kernels' (forward,
     dQ and dK/dV, each at hd 64 and 128) and the f32 product's registers,
     shared memory and spills (a spill fails), the f32 flash kernels'
     resident warps per SM at T = 2304 (under 8 fails); an old f32 flash or
     product kernel left in the library fails; the sampling epilogue's
     instances' registers and spills (a spill at VP 1152 fails; the old
     block-per-row kernel left in the library fails)
  3  each kernel against its plain version, at each single-request site
     (the NAR attention: the flash forward with the NAR's segments (ok, ok)
     at T = 2304, bf16 and f32); masked_attention at Tq = 16 (a verify pass at
     decode_steps = 16) and Tq = 40 (three query groups, the last ragged);
     the prep kernel of gemm_small_m (the LayerNorm rows of one verify
     pass); every product and every decode attention (here and in 3b-3d,
     3f) run twice, bitwise equal; the empty-launch floor of the timing
     harness on a line of its own; the sampling wrapper refuses VP > 2048
     and logits off 16 bytes
  3b the same at the batched sites: decode attention with per-row bounds
     (B = 4), the NAR attention at B = 4, the products of one batched step
     at M = 4 and 8 (bf16 and int8, each row equal to its M = 1 product),
     sampling over 8 rows
  3c the same for best_of and filtered sampling: the filtered epilogue
     (top_k 10 / 50, top_p 0.9 / 0.5, 1 and 20 rows; top-p alone, top-k
     alone, k = 200 above the kernel's sorted-candidate cap, ties at the
     k-th value, temperature 0.7, 8 rows; two runs bitwise), the grouped decode
     attention (1 request x 5 samples, 4 x 5), the products at M = 16 and
     20, and the f32 products (M = 1, 4, 8, 20: 1e-4 of scale, bitwise rows
     and runs, the head's argmax), the f32 prep rows (1e-6 of each row's
     scale) and attention (compute_dtype="float32")
  3f head dim 128 (d_model 1024, 8 heads, random weights from seed 0):
     the decode attention (draft step, verify pass, 16 queries, int8 K/V
     own column), the NAR attention (B = 1 and 4, T = 2304, as phases 3
     and 3b) and phase 3e's training attention against their plain
     versions; decode_block_fused and decode_verify against the CPU; one
     f32 and one bf16 train_step through the kernels and total_loss
     against the mask route; a greedy generate_audio, and a request and a
     batch of two whose NAR runs the flash forward (C >= 1536; the hd-128
     rows' launches are counted here); phase 3g's check at hd 128
  3g nar_generate at the offline benchmark cells' shape (48 rows, C = 256 +
     1024, bf16, the shipped width): every layer's attention through the
     flash forward at flash_attention_batched (exactly 84 launches, no call
     of the masked core), each launch's output within the flash rows' rule
     of the masked core's on the same q, k, v, each stage's codes equal to
     the masked core's stage on the same input but at its top-2 ties or
     where the same stage in f32 arithmetic picks the flash route's; the
     kernel timed at this shape beside the masked core and SDPA (PERF.md's
     row k1280; at hd 128, 8 heads, in phase 3f; also alone, both head dims:
     chip_smoke.nar_alone())
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
     POST /synthesize-long and a best_of=2 POST; the CLI (shipped depth) in
     a subprocess started with the phase and read in it
  5e the int8 KV cache, w8a8, decode_steps=1 and decode_mode="pallas":
     generate_audio in w8a8 and int8kv (greedy, sampled; int8kv best_of=5);
     the batch of 4 in both modes, each greedy w8a8 row bitwise its request
     alone in w8a8; fixed-prompt long text in int8kv as one batch of 8
     sentences; a server with quantize="int8kv" answering 4 concurrent
     POSTs; the CLI with --quantize w8a8 (a subprocess beside the phase's
     work); decode_steps=1 greedy, sampled and filtered; decode_mode="pallas"
     greedy; f32 greedy requests with decode_steps=1 and with "pallas"
     against 5d's CPU plain path on the same request
  3e the training attention (kernels/flash_attention.cu): the forward, dQ
     and dK/dV kernels against their plain versions at B = 4, H = 16,
     T = 1152 (text 128 + audio 1024), bf16 and f32, one padded segment
     per row and four packed ones, prefix T / 0 / 128; a ragged T = 1100
     (bf16 and f32, the same prefixes); bf16 q/k/v as views of a fused QKV
     with a transposed dO; two backward runs bitwise equal; the backward
     timed at prefix 128 and T (bf16 and f32); f32 q views that break the
     16-byte rule (a base off by one float, a row stride of hd + 1) raise
  5f training at the shipped width: train_step with AdamW on a fixed batch
     of four utterances for 10 steps (the loss falls), the kernel route
     against the mask route on that batch (loss, gradient cosine per
     leaf), a packed batch, two stage-1 ScaledAdam steps (the NAR
     parameters stay bitwise), one use_flash="auto" step, a profiled step
     (its bf16 backward must run on the tensor-core kernels alone)
  5g checkpoint files, continual, make_prompt and Whisper: the random
     full-width trees written with save_native and read by
     preload_models(checkpoint_dir) (greedy codes bitwise the params=
     route's); continual on 1200 tiled preset frames (t_audio 2048: the NAR
     through the flash forward, its launches counted at its site) in bf16,
     and in f32 against the same call on the CPU (codes equal); make_prompt
     of a 3 s WAV (codes equal to the CPU's EnCodec, or parted at a near
     tie), the npz as a prompt of generate_audio, the CLI's make-prompt in
     a subprocess beside the rest of the phase; a random Whisper of
     medium's width (LATER_LAYERS layers a stack), greedy (ids equal to the
     CPU's) and sampled (best_of 5); the card's times of the checkpoint
     load, EnCodec encode of 3 s and 10 s, continual, Whisper encode and
     decode, each beside the card's name and power limit
  5h long text overlapped on two CUDA streams, VALL-F and the Transformer
     TTS: 4 sentences with fuxuan's prompt tiled to 1980 frames (C = 2304:
     every fixed-prompt tail runs the flash forward on the pipeline's tail
     stream; <= 66 frames a sentence), default sampling; seed 0 (no coin
     slides): after an untimed sequential run and POST, seven pairs of the
     script's sequential loop (pipeline.synthesize per sentence) and the
     overlapped stream for stream_audio_from_long_text and seven for POST
     /synthesize-long (the sequential loop as the server's stream_fn),
     each pair's order the other way round from the last; seed 3 (sentence
     3 on sentence 2's codes) the stream against the sequential loop; the
     overlapped batch loop in fixed-prompt mode; all codes bitwise the
     sequential loop's; first- and last-wave times, their medians, and
     sentence 0's dispatch parts, with the GC pauses before the first wave
     and the caching allocator's new device allocations (a route's median
     paired first-wave
     difference, overlapped less sequential, may not exceed the spread of
     its sequential first waves);
     the host time to enqueue a tail; one torch.profiler trace of the
     overlapped loop (the card's busy share over the call, the tail kernels
     off the AR's stream, flash forwards among them or the phase fails, and
     each tail's device time inside the next sentence's AR span). VALL-F
     (AR greedy and sampled over a 512-frame buffer, NAR) and the
     Transformer TTS (inference of 200 frames, forward) at the shipped
     width (LATER_LAYERS layers) in bf16, timed; both in f32 at a short cap against the CPU
     (greedy tokens, NAR codes, frame counts equal; mels at 1e-4 of scale)
  5i the gradio UI, multi-GPU serving and dp × tp training: the UI's four
     tab callbacks (best_of 5) through a stub gradio on the later phases'
     bundle (finite waves, the .npz, launch got the port);
     batch_synthesize on two worker processes sharing the card, greedy:
     2 requests at per_chip=1 bitwise equal to pipeline.synthesize here at
     the batch's buckets, 4 at per_chip=2 bitwise equal to this process's
     batched route on each chunk, the same workers for both calls, each
     worker's launches by site (gemm_small_m, masked_attention and
     sample_epilogue in every worker); training from the shipped-depth
     model's weights on 5f's batch: one NCCL rank (a world of 1, through the launcher)
     takes the single-process f32 and bf16 steps, then (dp 2, tp 1) and
     (dp 1, tp 2), two gloo ranks each, both meshes at once, are held to
     it (losses, gradient cosines, the AdamW update of the same f32
     gradients, worked out on each rank's own slices; see train_ranks),
     each rank's host seconds by stage, its flash forward and backward
     launched, 215,266,308 parameters a rank at tp 2, replicated leaves
     bitwise equal across the tp ranks, each rank's peak memory; every
     time beside the card's name and power limit
  5j the native host runtime (native.py, no kernel): the C++ library built
     by g++ from a clean _build/ (its seconds); tokenize against the dict
     lookup on an English, a Chinese and a Japanese sentence (the Chinese
     one's phonemes written in where jieba is absent); a 3 s float32 44.1
     kHz stereo clip and a 3 s 16-bit 16 kHz clip decoded against the plain
     versions (int bitwise the stdlib path, float the double mean) and
     resampled within 1e-6 of the numpy formula; make_prompt of both on the
     later phases' bundle, EnCodec on the card (225 frames, codes equal to
     the same call on the CPU under the tie rule); host times of
     _prepare_text a language, encode through the C++ and the lookup, and
     load_wav of 10 s at 44.1 kHz through the C++ and wave + resample_poly
  5k the hybrid AR (Granite-4.0-H's published widths, random weights drawn
     on the card): kernels/ssm_step.cu's four kernels against their plain
     versions at the benchmark cell's widths (48 rows; the 64 x 64 x 128 f32
     state, conv_dim 4,352, RMSNorm rows of 2,048 and 4,096, a SwiGLU of
     8,192), twice bitwise, and masked_attention over grouped K/V (8 heads
     x 4 queries), each timed for one step's launches beside its bound; then
     one greedy synthesize_batch of 6 requests through the graphed hybrid
     block: codes bitwise the eager loop's, every row at its cap, and each
     kernel launched at decode_block_hybrid exactly its count a step times
     the steps run, the NAR's flash forward 84 times at
     flash_attention_batched (also alone: chip_smoke.hybrid_alone())
  8  the `kernels` JSON line, then the result line.
Device traces are the benchmark's (portbench, `--trace 1`) and
`tools/torch_flash_bench.py --parts trace` (`trace_run`), not this run's.
Launch counts are zeroed just before phase 5 and read after phase 6 (the
single-request path), zeroed again just before phase 5b and read after
phase 5c (the batched path), and once more just before phase 5d and read
after it (best_of and filtered sampling), and once more just before phase
5e and read after it (int8kv, w8a8, single steps, pallas), and once more
just before phase 5f and read after it (training), and once more just
before phase 5g and read after it (continual's flash forwards, the
prompt's requests), and once more just before phase 5h and read after it
(the long texts' requests and tails), and once more just before phase 5i
and read after it (this process's UI requests and the in-process serving
routes; the workers and ranks count their own and report them), and once
more just before phase 5j and read after it (none expected: host code and
EnCodec), and once more just before phase 5k's graphed batch and read after
it (the hybrid AR's site). The NAR must launch the flash forward at its
sites (at every C on the card) and masked_attention never there. Any
failure exits non-zero before the result line. No JAX is imported.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import re
import shutil
import statistics
import struct
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
    # the hybrid AR's decode block (ops/decode_hybrid.py, phase 5k): the JAX
    # package has no hybrid AR, so its kernels replace none
    "decode_block_hybrid": None,
}
# the same kernels at head dim 128 (phase 3f; their launches are counted there)
HD128 = "_hd128"
# layers a stack of the model that phases 5b-5i drive (the shipped width,
# random weights from seed 0): those phases drive the other entry points
# again and spend their time in per-layer launches, while the run has to
# stay well inside its limit. Phases 3-6, 3f, 5f, 5i's training ranks and 7
# keep the shipped 12.
LATER_LAYERS = 4
TPU.update({site + HD128: TPU[site] for site in (
    "decode_block_fused", "decode_verify", "flash_attention", "flash_attention_batched",
    "flash_attention_prefix", "flash_attention_train", "flash_attention_bwd")})
BATCHED_SITES = ("decode_block_fused_batched", "flash_attention_batched")
SLICE3_SITES = ("decode_block_fused_filtered", "decode_block_fused_beams",
                "decode_block_fused_grouped")
SLICE4_SITES = ("decode_block_fused_w8a8", "decode_block_fused_int8kv", "decode_step",
                "decode_step_fused", "decode_attention")
SLICE5_SITES = ("flash_attention_prefix", "flash_attention_train", "flash_attention_bwd")
KERNEL_FILE = {"flash_attention_fwd": "flash_attention", "flash_attention_bwd_dq": "flash_attention",
               "flash_attention_bwd_dkv": "flash_attention", "gemm_small_m_prep": "gemm_small_m",
               "conv_step": "ssm_step", "rms_norm_rows": "ssm_step", "swiglu_rows": "ssm_step"}


def say(msg: str) -> None:
    print(msg, flush=True)


CHILDREN: list = []  # processes started beside a phase's work, ended on any exit


def descendants(pid: int) -> list:
    """Every live process below `pid` (read from /proc)."""
    kids = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(d))
            except (OSError, IndexError, ValueError):
                pass
    return kids + [k for kid in kids for k in descendants(kid)]


def stop_children() -> None:
    """End every process this one started (the CLI runs, serving workers,
    training ranks, compilers) before a failing exit."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for pid in descendants(os.getpid()):
        try:
            os.kill(pid, 9)
        except OSError:
            pass


class Beside:
    """A command run as a process of its own beside the phase's other work
    (a CLI's start is mostly its interpreter's and the model's set-up):
    started now, read with `wait`."""

    def __init__(self, argv):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        CHILDREN.append(self.proc)

    def wait(self, timeout: float):
        """→ (return code, standard error, seconds from its start to its end)."""
        try:
            _, err = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            _, err = self.proc.communicate()
        return self.proc.returncode, err, time.perf_counter() - self.t0


@contextmanager
def phase(name: str, limit_s: float):
    """Time a phase; a watchdog ends the process if it outlives its limit
    (a hung launch blocks in C, where no Python exception can reach)."""
    def expire():
        print(f"FAIL phase {name}: over its {limit_s:.0f} s limit", file=sys.stderr, flush=True)
        stop_children()
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
    stop_children()
    sys.exit(1)


def device_ms(fn, reps=20):
    """Median device time of fn over reps, by CUDA events. A spin kernel
    queued first keeps the card busy while the host enqueues, so host launch
    overhead stays out of the interval."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(20_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


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


def filtered_request(api, bundle):
    """The traced filtered request of tools/torch_flash_bench.py's part
    "trace" (one filtered epilogue a frame):
    "Hello world." with paimon, top_k=50, top_p=0.9 → (phase seconds,
    frames)."""
    api.generate_audio("Hello world.", prompt="paimon", language="en", top_k=50, top_p=0.9,
                       max_duration=3.0, seed=0)
    return bundle.last.seconds, len(bundle.last.codes)


def trace_events(prof):
    """The events of a finished torch.profiler run, from its chrome trace."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def device_events(events):
    """(start µs, end µs, name, stream, correlation) of each kernel, copy
    and memset of a trace."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("args", {}).get("stream"), e.get("args", {}).get("correlation"))
            for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]


def launched_in(events, device, lo, hi):
    """The device events whose launch (a CUDA runtime or driver call,
    matched by correlation id) lies on the host inside [lo, hi)."""
    ids = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and lo <= float(e.get("ts", -1)) < hi}
    ids.discard(None)
    return [d for d in device if d[4] in ids]


def trace_run(label: str, run) -> None:
    """run() does one synthesis and returns (phase seconds, frames). Run it
    plainly (twice) and under torch.profiler, and report for each pipeline
    span the share of its wall time in which the card ran a kernel or a
    copy. Kernel times do not depend on the profiler; the host does more
    under it, so the share is also given against the unprofiled span's
    seconds. The tail's spans (nar, vocos) close once their work is
    enqueued on the tail stream: each is read up to the device end of the
    kernels launched inside it."""
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
    device = device_events(events)
    if not device or "ar" not in spans:
        say(f"  trace: not measured ({len(device)} device events, spans {sorted(spans)})")
        return
    for name in ("nar", "vocos"):
        if name in spans:
            lo, hi = spans[name]
            ends = [b for _, b, *_ in launched_in(events, device, lo, hi)]
            spans[name] = (lo, max([hi] + ends))
    out = {"request": f"{label}, {frames} frames"}
    for name, (lo, hi) in sorted(spans.items()):
        inside = [(a, b) for a, b, *_ in device if b > lo and a < hi]
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
    for a, b, n, *_ in device:
        if b > lo and a < hi:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
    out["ar_device_ms_by_kernel"] = {n[:80]: round(t, 3) for n, t in
                                     sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    # every kernel of gemm_small_m (its prep, products and f32 kind); with
    # programmatic dependent launch a product's span includes its wait
    gemm = {n: t for n, t in by_name.items() if n.replace("void ", "").startswith("gemm_")}
    out["ar_gemm_small_m_device_ms"] = round(sum(gemm.values()), 3)
    out["ar_gemm_small_m_busy_ms"] = round(busy_ms(
        [(a, b) for a, b, n, *_ in device if b > lo and a < hi and n in gemm], lo, hi), 3)
    # the sampling epilogue's kernels (filtered sampling runs one a frame)
    out["ar_sample_epilogue_device_ms"] = round(sum(
        t for n, t in by_name.items() if "sample_epilogue" in n), 3)
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


def bf16_ulp(x):
    """One bf16 ulp of each element of x (f32)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -100))) - 7)


def flash_rows_rule(out, ref, spread, seg):
    """The bf16 NAR forward's rule on the valid rows (seg [B, T] 1): each
    element of `out` within one bf16 ulp + 1e-5 of max|ref| of the f32
    reference `ref`, plus 2^-8 of `spread` (sum(p |v|) / l): both round each
    p to bf16 once (at most 2^-9 of p each way), the kernel at the running
    row max of its key tiles → (|out - ref|, one ulp + 1e-5 of max, the
    bound), each over the valid rows' elements."""
    rows = seg.bool()[:, None, :, None].expand_as(ref)
    diff = (out.float() - ref).abs()[rows]
    one_ulp = bf16_ulp(ref)[rows] + 1e-5 * float(ref.abs().max())
    return diff, one_ulp, one_ulp + 2.0 ** -8 * spread[rows]


def check_flash_nar(dev, entry, g, site, x_len, audio_len, s_text, T, H=16, hd=64,
                    dtype=None) -> None:
    """The flash forward at the NAR's shapes against its plain version:
    q/k/v as the NAR hands them (views of the fused QKV product of a
    d_model H * hd model), its key-padding rule as segments (ok, ok),
    prefix T. On the valid rows (the NAR discards the others) each output
    element must lie within one bf16 ulp + 1e-5 of max|ref| of the plain
    version's f32 output, plus 2^-8 of sum(p |v|) / l: both round each p to
    bf16 once (at most 2^-9 of p each way), the kernel at the running row
    max of its key tiles (as the JAX library's kernel does), the plain
    version at the final one. lse within 1e-3. dtype float32 (the f32 NAR,
    compute_dtype="float32"; a row beside the site's, not in the kernels
    line): the valid rows within 2e-5 of their scale, lse within 1e-3."""
    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain, valid_pairs,
    )

    dtype = dtype or torch.bfloat16
    B, D = len(x_len), H * hd
    cols = torch.arange(T, device=dev)[None, :]
    xl, al = (torch.tensor(a, dtype=torch.int32, device=dev) for a in (x_len, audio_len))
    seg = torch.where(cols < s_text, cols < xl[:, None], (cols - s_text) < al[:, None]
                      ).to(torch.int32)
    qkv = torch.randn((B, T, 3 * D), generator=g, device=dev).to(dtype)
    q, k, v = (qkv[..., i * D:(i + 1) * D].view(B, T, H, hd).transpose(1, 2)
               for i in range(3))
    o, lse = flash_attention_fwd(q, k, v, seg, seg, T, site="check")
    if dtype == torch.float32:
        ref, lref = flash_attention_plain(q, k, v, seg, seg, T)
        torch.cuda.synchronize()
        rows = seg.bool()[:, None, :, None].expand_as(ref)
        err = float((o - ref).abs()[rows].max())
        scale = float(ref.abs()[rows].max())
        err_l = float((lse - lref).abs()[rows[..., 0]].max())
        if not (err <= 2e-5 * scale and err_l <= 1e-3):
            fail(f"flash_attention_fwd@{site} f32: out err {err} of scale {scale}, lse err"
                 f" {err_l}")
        say(f"  flash_attention_fwd@{site} f32: valid rows out err {err:.3e} (scale"
            f" {scale:.3f}), lse err {err_l:.3e}")
        ok = valid_pairs(seg, seg, T)
        pairs = int(ok.sum()) * H
        mask = ok[:, None]
        lib_ms = device_ms(lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        n = B * H * T * hd
        entry("flash_attention_fwd", site, err,
              device_ms(lambda: flash_attention_fwd(q, k, v, seg, seg, T, site="check")),
              device_ms(lambda: flash_attention_plain(q, k, v, seg, seg, T)),
              4 * n * 4 + B * H * T * 4 + 2 * B * T * 4, 4 * hd * pairs, lib_ms,
              f"1 launch: NAR, B={B}, H={H}, hd={hd}, T={T}, f32, segments (ok, ok), prefix T;"
              f" {int(seg.sum())} valid rows, {pairs} valid pairs", False, F32_OPS_PER_S)
        del qkv, q, k, v, o, ref, mask, ok
        return
    ref, lref = flash_attention_plain(q.float(), k, v, seg, seg, T)  # f32 out
    spread = flash_attention_plain(q.float(), k, v.abs(), seg, seg, T)[0]
    torch.cuda.synchronize()
    rows = seg.bool()[:, None, :, None].expand_as(ref)  # the valid query rows
    diff, one_ulp, tol = flash_rows_rule(o, ref, spread, seg)
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
          f"1 launch: NAR, B={B}, H={H}, hd={hd}, T={T}, bf16, segments (ok, ok), prefix T;"
          f" {int(seg.sum())} valid rows, {pairs} valid pairs")
    del qkv, q, k, v, o, ref, spread, own, mask, ok


TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
CORE_KERNELS = ("flash_fwd_ffma_kernel", "flash_bwd_dq_ffma_kernel", "flash_bwd_dkv_ffma_kernel")
TC_HEAD_DIMS = (64, 128)  # each flash kernel is a template on the head dim
# the f32 flash and product designs that the ffma kernels and gemm_ffma_kernel
# replaced: none may be left in the library
OLD_F32_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                   "gemm_f32_kernel")
# the decode attention: a cluster per (row, head, query group); the one block
# per query that it replaced may not be left in the library
ATT_KERNEL, OLD_ATT_KERNEL = "masked_attention_split_kernel", "masked_attention_kernel"
ATT_KV = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8"}  # mangled k/v types
# the sampling epilogue: the row in registers, unfiltered over a few warps
# (draw), filtered in one warp (filter), each a template on the float4 chunks
# a thread; the one block per row that it replaced may not be left
SAMPLE_KERNEL, OLD_SAMPLE_KERNEL = r"sample_epilogue_(?:draw|filter)_kernel", "sample_epilogue_kernel"
# the instances the repo's configurations launch (VP = 1152), held to no spill
SAMPLE_HELD = {("sample_epilogue_draw_kernel", 3), ("sample_epilogue_filter_kernel", 9)}


def tc_kernel_report(lib) -> None:
    """Phase 2's report on the build: each kernel's ptxas line; for the bf16
    flash kernels (tensor cores) at each head dim their registers, shared
    memory, spills and any serialized wgmma ptxas reports, their dynamic
    shared memory per block, and their HGMMA count in the SASS (cuobjdump);
    for the f32 flash kernels (CORE_KERNELS<hd>: the forward, dQ and dK/dV)
    and the f32 product (gemm_ffma_kernel<MR, CS>) their registers, shared
    memory and spills, the f32 backward kernels' dynamic shared memory per
    block, and each f32 flash kernel's resident warps per SM at T = 2304; for
    the decode attention (ATT_KERNEL<k/v type, hd, queries a group>) each
    instance's registers, shared memory and spills, its dynamic shared
    memory, threads a block and the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters); for the sampling epilogue
    (SAMPLE_KERNEL<float4 chunks a thread>) each instance's registers and
    spills (held to none in SAMPLE_HELD, the instances at VP 1152). Fails if a tensor-core kernel has no HGMMA instruction, ptxas
    reports a spill in any of these, an f32 flash kernel keeps fewer than 8
    warps resident per SM, a CUDA-core flash kernel is built for bf16 (those
    run f32 only), an attention instance cannot place one cluster, or an old
    f32 kernel (OLD_F32_KERNELS), the old decode attention (OLD_ATT_KERNEL) or
    the old sampling epilogue (OLD_SAMPLE_KERNEL) is left in the library."""
    import torch

    from vallex_tpu_torch.kernels.masked_attention import kernel_info
    from vallex_tpu_torch.kernels import loader

    def instance(kernel, hd, fn_name):
        """fn_name (mangled) is kernel<hd>: _Z<len>kernelILi<hd>E..."""
        return re.search(rf"\d{kernel}ILi{hd}E", fn_name) is not None

    def old_f32(fn_name):
        return any(re.search(rf"\d{k}[A-Z]", fn_name) for k in OLD_F32_KERNELS)

    def old_att(fn_name):
        return (re.search(rf"\d{OLD_ATT_KERNEL}I", fn_name) is not None
                or re.search(rf"\d{OLD_SAMPLE_KERNEL}", fn_name) is not None)

    report = lib.parent / ("ptxas_" + lib.name.split("_")[-1].split(".")[0] + ".txt")
    if report.exists():
        text = report.read_text()
        for line in text.splitlines():
            if "Used" in line and "registers" in line:
                say("  ptxas: " + line.split("ptxas info    :")[-1].strip())
        for blk in text.split("Compiling entry function")[1:]:
            head = blk.split("\n")[0]
            if old_f32(head) or old_att(head):
                fail(f"an old kernel is still built: {head.strip()[:100]}")
            name = [f"{k}<{hd}>" for k in TC_KERNELS + CORE_KERNELS
                    for hd in TC_HEAD_DIMS if instance(k, hd, head)]
            mr_cs = re.search(r"\dgemm_ffma_kernelILi(\d+)ELi(\d+)E", head)
            if mr_cs:
                name = [f"gemm_ffma_kernel<{mr_cs.group(1)}, {mr_cs.group(2)}>"]
            att = re.search(rf"\d{ATT_KERNEL}I(13__nv_bfloat16|f|a)Li(\d+)ELi(\d+)E", head)
            if att:
                name = [f"{ATT_KERNEL}<{ATT_KV[att.group(1)]}, {att.group(2)}, {att.group(3)}>"]
            nc = re.search(rf"\d({SAMPLE_KERNEL})ILi(\d+)E", head)
            if nc:
                name = [f"{nc.group(1)}<{nc.group(2)}>"]
            if name:
                said = [ln.split(":", 1)[-1].strip() for ln in blk.splitlines()[1:]
                        if any(w in ln for w in ("stack frame", "Used", "wgmma", "smem"))]
                say(f"  ptxas {name[0]}: " + "; ".join(said))
                spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", blk)
                # the other sampling instances serve widths no configuration of
                # the repo has: printed, not held
                unheld = nc is not None and (nc.group(1), int(nc.group(2))) not in SAMPLE_HELD
                if any(int(x) for x in spills) and not unheld:
                    fail(f"{name[0]}: ptxas reports spills: {'; '.join(said)}")
    lib_ = loader.library()
    for hd in TC_HEAD_DIMS:
        say(f"  dynamic shared memory per block at T = 2304, hd {hd}: flash_fwd_tc_kernel"
            f" {lib_.vx_flash_attention_fwd_smem(2304, hd)}, flash_bwd_dq_tc_kernel"
            f" {lib_.vx_flash_attention_bwd_smem(2304, 0, hd)}, flash_bwd_dkv_tc_kernel"
            f" {lib_.vx_flash_attention_bwd_smem(2304, 1, hd)} bytes")
        say(f"  dynamic shared memory per block at T = 2304, hd {hd}: flash_bwd_dq_ffma_kernel"
            f" {lib_.vx_flash_attention_bwd_f32_smem(2304, 0, hd)}, flash_bwd_dkv_ffma_kernel"
            f" {lib_.vx_flash_attention_bwd_f32_smem(2304, 1, hd)} bytes")
        for kernel, warps in zip(CORE_KERNELS, (
                lib_.vx_flash_attention_fwd_f32_warps(2304, hd),
                lib_.vx_flash_attention_bwd_f32_warps(2304, 0, hd),
                lib_.vx_flash_attention_bwd_f32_warps(2304, 1, hd))):
            say(f"  {kernel}<{hd}>: {warps} warps resident per SM at T = 2304"
                f" (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            if warps < 8:
                fail(f"{kernel}<{hd}>: {warps} resident warps per SM, want at least 8")
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32"), (torch.int8, "int8")):
        for hd in TC_HEAD_DIMS:
            for Tq in (1, 8, 16):
                info = kernel_info(dt, hd, Tq)
                say(f"  {ATT_KERNEL} {kind} k/v, hd {hd}, Tq {Tq}: {info['smem_bytes']} bytes of"
                    f" dynamic shared memory, {info['threads']} threads a block, clusters of"
                    f" {info['cluster_blocks']}, {info['clusters']} resident at once"
                    f" (cudaOccupancyMaxActiveClusters)")
                if info["clusters"] < 1:
                    fail(f"{ATT_KERNEL} {kind} hd {hd} Tq {Tq}: the card cannot place a cluster")
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
        for hd in TC_HEAD_DIMS:
            tc = [c for f, c in per_fn.items() if instance(kernel, hd, f)]
            if not tc or tc[0][0] == 0:
                fail(f"{kernel}<{hd}>: no HGMMA instruction in its SASS ({tc})")
            say(f"  SASS (cuobjdump -sass): {kernel}<{hd}> holds {tc[0][0]} HGMMA and"
                f" {tc[0][1]} HMMA instructions")
    core = [f for f in per_fn if any(re.search(rf"\d{k}I", f) for k in CORE_KERNELS)]
    bf16_core = [f for f in core if "bfloat16" in f]
    if bf16_core or not core:
        fail(f"CUDA-core flash kernels in the library: {core}; want f32 instances only")
    old = [f for f in per_fn if old_f32(f) or old_att(f)]
    if old:
        fail(f"old kernels left in the library: {old}")
    att = [f for f in per_fn if re.search(rf"\d{ATT_KERNEL}I", f)]
    if len(att) != 3 * len(TC_HEAD_DIMS) * 3:
        fail(f"{ATT_KERNEL}: {len(att)} instances in the library, want 18 (3 k/v types x 2"
             f" head dims x groups of 1, 8, 16 queries)")
    say(f"  SASS: {len(core)} CUDA-core flash kernels, all f32 (no bf16 instance); {len(att)}"
        f" {ATT_KERNEL} instances; no {' or '.join(OLD_F32_KERNELS + (OLD_ATT_KERNEL,))}")


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


def train_kernel_checks(dev, entry, g, H=16, hd=64, suffix="") -> None:
    """Phase 3e: the flash forward, dQ and dK/dV kernels against their plain
    versions at the training shapes (B = 4, H = 16, T = 1152 = text 128 +
    audio 1024, hd 64), bf16 and f32, one padded segment per row and four
    packed ones, prefix P = T (key padding, the NAR), 0 (causal) and 128
    (the AR's prefix-causal mask); a ragged T = 1100 (text 128 + audio 972,
    not a multiple of the kernels' 64-row tiles) at the same prefixes; bf16
    q/k/v as the strided views of a fused [B, T, 3 H 64] QKV product (as the
    training layers pass them) with dO a transposed view; two backward runs
    bitwise equal in every case. Times the backward at P = 128 (rows y, z)
    and at P = T (rows yT, zT), bf16 and f32, against SDPA's whole backward,
    with the pairs of the tiles each kernel visits (visit_tiles_plain). H
    and hd: the same at head dim 128 (H = 8), its rows at the sites +
    suffix."""
    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
        flash_attention_fwd, flash_attention_plain, valid_pairs,
    )
    # the tile-visit rule's plain version; absent in older trees that
    # tools/torch_flash_bench.py --root times with these checks
    visit = getattr(importlib.import_module("vallex_tpu_torch.kernels.flash_attention"),
                    "visit_tiles_plain", None)
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
        # the backward at P = 128 in both layouts (rows y, z) and at P = T
        # (rows yT, zT: the NAR's training backward; printed beside the
        # site's row); the pairs of the tiles each kernel visits (own tiles
        # of 64 rows)
        in_line = in_line and P == S
        row = "" if P == S else " (rows yT, zT)"
        seen = [f"{int((visit(seg, seg, P, 64, side) >= 0).sum()) * 64 * 64 * H} in visited"
                " tiles" if visit else "visited tiles not counted" for side in (True, False)]
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
              f"1 launch: dq and di, {what}, {seen[0]}; library: SDPA's"
              f" whole backward{row}", in_line, rate)
        entry("flash_attention_bwd_dkv", "flash_attention_bwd" + suffix, max(err[1:]),
              device_ms(lambda: flash_attention_bwd_dkv(q, k, v, seg, seg, P, do, lse, di)),
              device_ms(lambda: flash_attention_bwd_dkv_plain(q, k, v, seg, seg, P, o, lse,
                                                              do)),
              6 * n * es + 2 * row_bytes + seg_bytes, 8 * hd * pairs, lib_bwd,
              f"1 launch: dk and dv, {what}, {seen[1]}; library: SDPA's"
              f" whole backward{row}", in_line, rate)
        del qr, kr, vr, mask


def check_layout_rule(dev) -> None:
    """Phase 3e: the f32 forward reads q/k/v in 16-byte pieces, so a view
    that breaks the 16-byte rule raises, naming the rule, before any launch:
    q with a base off by one float, and with a row stride of hd + 1."""
    import torch

    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.kernels.flash_attention import flash_attention_fwd

    B, H, T, hd = 1, 2, 128, 64
    seg = torch.ones((B, T), dtype=torch.int32, device=dev)
    kv = torch.randn((B, H, T, hd), device=dev)
    for what, q in (("a base off by one float",
                     torch.randn(B * H * T * hd + 1, device=dev)[1:].view(B, H, T, hd)),
                    ("a row stride of hd + 1",
                     torch.randn((B, H, T, hd + 1), device=dev)[..., :hd])):
        before = dict(loader.launch_counts)
        try:
            flash_attention_fwd(q, kv, kv, seg, seg, T, site="check")
        except ValueError as exc:
            if "16-byte" not in str(exc) or dict(loader.launch_counts) != before:
                fail(f"flash_attention_fwd f32 q with {what}: raised {exc!r}, launches"
                     f" {dict(loader.launch_counts) != before}")
            say(f"  flash_attention_fwd f32 q with {what}: raises ({exc})")
        else:
            fail(f"flash_attention_fwd f32 q with {what}: no error (the 16-byte rule)")


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
    cuda_core_bwd = [n for n in flash if n.startswith(CORE_KERNELS[1:])]  # the f32 backward
    if cuda_core_bwd or not all(k in {n.split("<")[0] for n in flash} for k in TC_KERNELS):
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


# ---------------------------------------------------------------------------
# Checkpoint files, continual, make_prompt and Whisper (phase 5g):
# module-level so each step reads only what it is handed.
# ---------------------------------------------------------------------------

CONTINUAL_T = 1200  # frames: t_audio bucket 2048, so the NAR runs the flash forward
RVQ_TIE = 1e-5  # tests/test_torch_encodec.py's tie rule


def card_time(label: str, secs: float, card: str) -> None:
    say(f"  time {label}: {secs:.4f} s  [{card}]")


def synced(dev, fn):
    """(fn(), host seconds to the end of its device work)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def rvq_parted(codes, ref, latents, codebooks, tie=RVQ_TIE, label="5g make_prompt") -> int:
    """Frames whose codes differ from `ref`'s; each must part at a near tie:
    at its first differing stage the reference residual's distances
    ‖e‖² − 2 r·e to the two codes within `tie` of their magnitude."""
    import numpy as np

    codes, ref = np.asarray(codes).reshape(-1, 8), np.asarray(ref).reshape(-1, 8)
    lat = np.asarray(latents, np.float64).reshape(len(ref), -1)
    cb = np.asarray(codebooks, np.float64)
    parted = 0
    for t in np.nonzero(np.any(codes != ref, axis=1))[0]:
        q = int(np.argmax(codes[t] != ref[t]))
        r = lat[t] - sum(cb[j][ref[t, j]] for j in range(q))
        d = (cb[q] ** 2).sum(-1) - 2 * cb[q] @ r
        a, b = d[ref[t, q]], d[codes[t, q]]
        if abs(a - b) > tie * max(abs(a), abs(b), 1.0):
            fail(f"{label}: frame {t} stage {q}: code {codes[t, q]} on the card,"
                 f" {ref[t, q]} on the CPU, distances {b:.6g} / {a:.6g} (not a tie)")
        parted += 1
    return parted


def prompt_paths(dev, api, bundle, card: str, flash_site=("flash_attention_fwd",
                                                          "flash_attention")) -> None:
    """Phase 5g on the model of `bundle` (random weights from seed 0): a
    checkpoint directory written with save_native read back by
    preload_models (greedy codes bitwise the params= route's); continual on
    CONTINUAL_T frames in bf16 (the flash forward counted at its site) and
    f32 against the CPU; make_prompt of a 3 s WAV against the CPU's
    EnCodec, used as a prompt, and the CLI's make-prompt; a random Whisper of
    medium's width (LATER_LAYERS layers a stack), greedy (ids equal to the
    CPU's) and sampled."""
    import numpy as np
    import torch

    from vallex_tpu_torch.asr import whisper as W
    from vallex_tpu_torch.codec import encodec as EC
    from vallex_tpu_torch.codec.vocos import init_vocos
    from vallex_tpu_torch.convert import load_tree
    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.models.vallex import init_vallex
    from vallex_tpu_torch.utils import checkpoint as CK
    from vallex_tpu_torch.utils.audio import load_wav, save_wav

    cfg, ecfg = bundle.cfg, bundle.ecfg
    trees = dict(params=init_vallex(cfg, torch.Generator().manual_seed(0)),
                 vocos_params=init_vocos(torch.Generator().manual_seed(1)),
                 encodec_params=EC.init_encodec(torch.Generator().manual_seed(2)))
    td = tempfile.mkdtemp(prefix="vallex-5g-")
    try:
        # ---- checkpoint files -> preload_models -> the params= route
        t0 = time.perf_counter()
        for name, key in (("vallex", "params"), ("vocos", "vocos_params"),
                          ("encodec", "encodec_params")):
            CK.save_native(os.path.join(td, f"{name}-jax.npz"), trees[key])
        mb = sum(os.path.getsize(os.path.join(td, f)) for f in os.listdir(td)) / 2**20
        say(f"  wrote vallex / vocos / encodec -jax.npz ({mb:.1f} MiB) in"
            f" {time.perf_counter() - t0:.2f} s")
        greedy = dict(text="Hello world.", prompt="paimon", language="en", top_k=1,
                      max_duration=2.0)
        ck, t_load = synced(dev, lambda: api.preload_models(td, device=dev, cfg=cfg, ecfg=ecfg))
        card_time("preload_models(checkpoint_dir) at full width", t_load, card)
        api.generate_audio(**greedy)
        codes_ck = ck.last.codes
        pb = api.preload_models(device=dev, cfg=cfg, ecfg=ecfg, checkpoint_dir=td, **trees)
        api.generate_audio(**greedy)
        if ck.encodec is None or ck.vocos is None:
            fail("5g: preload_models(checkpoint_dir) left Vocos or EnCodec out")
        if not np.array_equal(codes_ck, pb.last.codes):
            fail(f"5g: greedy codes from the checkpoint files {codes_ck.shape} differ from the"
                 f" params= route's {pb.last.codes.shape}")
        say(f"  checkpoint round trip: greedy codes ({len(codes_ck)} frames) bitwise the"
            f" params= route's")
        del ck, pb
        for name in os.listdir(td):
            os.remove(os.path.join(td, name))

        # ---- continual, bf16 on the card (the flash forward) and f32 against the CPU
        api._bundle = bundle
        audio, _, _ = api._load_prompt("paimon")
        src = np.tile(audio, (-(-CONTINUAL_T // len(audio)), 1))[:CONTINUAL_T]
        text = "The quick brown fox jumps over the lazy dog."
        before = loader.launch_counts.get(flash_site, 0)
        api.continual(text, src, language="en")  # warm
        out, t_c = synced(dev, lambda: api.continual(text, src, language="en"))
        n_flash = (loader.launch_counts.get(flash_site, 0) - before) // 2
        prefix = min(CONTINUAL_T // 2, 225)
        if out.shape != (CONTINUAL_T - prefix, 8) or not np.array_equal(out[:, 0], src[prefix:, 0]):
            fail(f"5g continual: shape {out.shape}, codebook 0 kept:"
                 f" {out.shape[0] == CONTINUAL_T - prefix and np.array_equal(out[:, 0], src[prefix:, 0])}")
        if out.min() < 0 or out.max() >= 1024 or n_flash == 0:
            fail(f"5g continual: codes in [{out.min()}, {out.max()}], {n_flash} flash launches")
        card_time(f"continual T={CONTINUAL_T} (bf16, {n_flash} flash forwards a call)", t_c, card)
        e32 = dataclasses.replace(ecfg, compute_dtype="float32")
        api.preload_models(device=dev, cfg=cfg, ecfg=e32, checkpoint_dir=td,
                           params=trees["params"])
        out32, t_c32 = synced(dev, lambda: api.continual(text, src, language="en"))
        api.preload_models(device="cpu", cfg=cfg, ecfg=e32, checkpoint_dir=td,
                           params=trees["params"])
        t0 = time.perf_counter()
        cpu32 = api.continual(text, src, language="en")
        t_cpu = time.perf_counter() - t0
        if not np.array_equal(out32, cpu32):
            diff = np.argwhere(out32 != cpu32)
            fail(f"5g continual f32: {len(diff)} codes differ from the CPU's, first at {diff[0]}")
        say(f"  continual f32: codes on the card equal the CPU's ({out32.shape}; the CPU took"
            f" {t_cpu:.1f} s)")
        card_time(f"continual T={CONTINUAL_T} (f32)", t_c32, card)
        api._bundle = bundle

        # ---- make_prompt of a 3 s WAV on the card, against the CPU's EnCodec
        t = np.arange(3 * 24000) / 24000.0
        clip = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
                + 0.02 * np.random.RandomState(0).randn(len(t))).astype(np.float32)
        wav_path = os.path.join(td, "clip.wav")
        save_wav(wav_path, clip)
        cli = Beside([sys.executable, "-m", "vallex_tpu_torch.cli", "make-prompt", "cli",
                      wav_path, "--random-weights", "--transcript", "Hello world.", "--out-dir",
                      td, "--checkpoints", os.path.join(td, "none")])
        if bundle.encodec is None:
            fail("5g: the random bundle has no EnCodec")
        out_path, t_mp = synced(dev, lambda: api.make_prompt(
            "smoke", wav_path, transcript="Hello world, this is a test.", out_dir=td))
        card_time("make_prompt of 3 s (WAV read, G2P, EnCodec encode)", t_mp, card)
        data = np.load(out_path)
        gpu_codes = data["audio_tokens"]
        if gpu_codes.shape != (1, 225, 8) or gpu_codes.dtype != np.int64 \
                or data["text_tokens"].dtype != np.int64 or int(data["lang_code"]) != 2:
            fail(f"5g make_prompt npz: {gpu_codes.shape} {gpu_codes.dtype}"
                 f" {data['text_tokens'].dtype} lang {int(data['lang_code'])}")
        wav24, _ = load_wav(wav_path)
        enc_cpu = EC.encodec_from_tree(trees["encodec_params"], device="cpu")
        x = torch.from_numpy(wav24[None])
        cpu_codes = EC.encode(enc_cpu, x).numpy()
        lat = EC.encode_latent(enc_cpu, x).numpy()
        parted = rvq_parted(gpu_codes, cpu_codes, lat, enc_cpu.codebooks.numpy())
        say(f"  make_prompt: {gpu_codes.shape[1]} frames, codes on the card equal the CPU's"
            f" but {parted} frames parted at a near tie (rel {RVQ_TIE})")
        for secs in (3, 10):
            w = torch.from_numpy(np.tile(wav24, 4)[: secs * 24000][None]).to(dev)
            EC.encode(bundle.encodec, w)
            ts = [synced(dev, lambda: EC.encode(bundle.encodec, w))[1] for _ in range(3)]
            card_time(f"EnCodec encode of {secs} s (median of 3)", statistics.median(ts), card)
        a, txt, lang = api._load_prompt(out_path)
        if a.shape != (225, 8) or lang != "en":
            fail(f"5g: the npz loads as a prompt of {a.shape}, {lang}")
        wave = api.generate_audio("Hi.", prompt=out_path, language="en", top_k=1,
                                  max_duration=2.0)
        if not (wave.ndim == 1 and len(wave) > 0 and np.isfinite(wave).all()):
            fail(f"5g: generate_audio with the made prompt: {wave.shape}")
        say(f"  generate_audio(prompt=<made npz>): {len(wave) / 24000:.2f} s of audio")

        # ---- Whisper of medium's width, LATER_LAYERS layers a stack, random weights
        wcfg = W.WhisperConfig(encoder_layers=LATER_LAYERS, decoder_layers=LATER_LAYERS)
        tree = W.init_whisper(wcfg, torch.Generator(device=dev).manual_seed(0))
        wm = load_tree(W.Whisper(wcfg), tree, dtype=torch.float32, device=dev)
        wav16, _ = load_wav(wav_path, target_sr=W.SAMPLE_RATE)
        mel = W.log_mel_spectrogram(torch.from_numpy(W.pad_or_trim(wav16)).to(dev))
        W.encode(wm, mel)
        enc, t_enc = synced(dev, lambda: W.encode(wm, mel))
        card_time(f"Whisper (medium width, {LATER_LAYERS} + {LATER_LAYERS} layers) encode of 30 s",
                  t_enc, card)
        lang_id = W.detect_language(wm, enc)
        pre = torch.tensor([wcfg.sot, lang_id, wcfg.transcribe, wcfg.no_timestamps], device=dev)
        buf, t_dec = synced(dev, lambda: W.greedy_decode(wm, enc, pre, max_len=24))
        card_time("Whisper greedy decode, 20 tokens", t_dec, card)
        (ids, lang), t_g = synced(dev, lambda: W.transcribe_ids(wm, wav16, max_len=24))
        (ids_s, lang_s), t_s = synced(dev, lambda: W.transcribe_ids(
            wm, wav16, temperature=1.0, best_of=5, sample_len=16, seed=0))
        if not (len(ids) > 0 and len(ids_s) > 0
                and all(0 <= i < wcfg.vocab for i in np.concatenate([ids, ids_s]))):
            fail(f"5g Whisper: greedy {len(ids)} ids, sampled {len(ids_s)} ids")
        card_time(f"Whisper transcribe_ids greedy ({len(ids)} ids)", t_g, card)
        card_time(f"Whisper transcribe_ids best_of 5 ({len(ids_s)} ids of the best lane)", t_s,
                  card)
        wm_cpu = load_tree(W.Whisper(wcfg), tree, dtype=torch.float32, device="cpu")
        del tree
        t0 = time.perf_counter()
        ids_cpu, lang_cpu = W.transcribe_ids(wm_cpu, wav16, max_len=24)
        if lang_cpu != lang or not np.array_equal(ids_cpu, ids):
            fail(f"5g Whisper greedy: card {lang} {ids.tolist()} vs CPU {lang_cpu}"
                 f" {ids_cpu.tolist()}")
        say(f"  Whisper greedy: {len(ids)} ids and language {lang!r} on the card equal the"
            f" CPU's ({time.perf_counter() - t0:.1f} s on the CPU)")
        rc, err, secs = cli.wait(240)
        if rc != 0 or not os.path.exists(os.path.join(td, "cli.npz")):
            fail(f"5g CLI make-prompt: rc {rc}: {err[-1500:]}")
        say(f"  python -m vallex_tpu_torch.cli make-prompt: rc 0 in {secs:.2f} s (a process"
            f" of its own, beside the phase's card work since make_prompt)")
    finally:
        shutil.rmtree(td, ignore_errors=True)
        api._bundle = bundle


# ---------------------------------------------------------------------------
# Long text overlapped on two streams, VALL-F and the Transformer TTS (phase
# 5h): module-level so each step reads only what it is handed.
# ---------------------------------------------------------------------------

LONG_5H = ("The quick brown fox jumps over the lazy dog. It was a bright cold day in April."
           " Speech turns text into sound. We go home.")
PROMPT_5H = "fuxuan"
# fuxuan's 758 frames tiled to 1980 (its 129 text tokens kept): the audio
# bucket stays 2048 (C = 256 + 2048 = 2304, every fixed-prompt tail through
# the flash forward) and leaves a sentence <= 66 frames, where fuxuan
# itself leaves 1288 and random weights run most of them (~5 ms a frame)
PROMPT_5H_FRAMES = 1980
# pairs of sequential and overlapped runs a route: the host's bursts in
# sentence 0's AR (the same call in both arms; 0.33-0.67 s for a 0.45 s
# median) ran three pairs in a row once, which five pairs cannot outvote
PAIRS_5H = 7
SLIDE_SEED = 3  # coins keep, keep, slide: sentence 3 runs on sentence 2's codes


def tiled_prompt(api, out_dir: str) -> str:
    """PROMPT_5H with its audio tiled to PROMPT_5H_FRAMES frames, written
    as a prompt npz under out_dir → its path."""
    import numpy as np

    src = np.load(api._find_prompt(PROMPT_5H))
    audio = np.asarray(src["audio_tokens"]).reshape(-1, 8)
    reps = -(-PROMPT_5H_FRAMES // len(audio))
    path = os.path.join(out_dir, f"{PROMPT_5H}_tiled.npz")
    np.savez(path, audio_tokens=np.tile(audio, (reps, 1))[None, :PROMPT_5H_FRAMES].astype(np.int64),
             text_tokens=np.asarray(src["text_tokens"]), lang_code=np.asarray(src["lang_code"]))
    return path


def sequential_waves(api, bundle, text: str, prompt: str, mode: str, seed: int):
    """The long-text loop with nothing overlapped, as the port streamed
    before the overlap: pipeline.synthesize per sentence, each fetched
    before the next starts, with the JAX package's pre-drawn coins and
    seeds seed + i. Yields each sentence's wave."""
    import numpy as np

    fixed = api._load_prompt(prompt)
    rng = np.random.RandomState(seed)
    cur = fixed
    for i, sent in enumerate(api.split_text_into_sentences(text)):
        audio, text_prompt, lang_pr = cur
        ids, langs = api._prepare_text(bundle, sent, text_prompt, lang_pr, "en")
        res = bundle.pipeline.synthesize(ids, langs, audio if len(audio) else None,
                                         seed=seed + i)
        yield res.wave
        coin = rng.rand() if mode == "sliding-window" else 1.0
        if coin < 0.5:
            cur = api._slid_prompt_triple(bundle, sent, res.codes, "en")
        elif mode == "sliding-window":
            cur = fixed


@contextmanager
def dispatches(bundle):
    """bundle.pipeline.synthesize_async recorded for the block (synthesize
    goes through it too): a list of (host clock at the call, at its return,
    the handle) per sentence."""
    pipe, calls = bundle.pipeline, []
    orig = pipe.synthesize_async

    def rec(*args, **kwargs):
        t = time.perf_counter()
        h = orig(*args, **kwargs)
        calls.append((t, time.perf_counter(), h))
        return h

    pipe.synthesize_async = rec
    try:
        yield calls
    finally:
        del pipe.synthesize_async


def server_waves(long_text: str, prompt: str, stream_fn=None):
    """POST /synthesize-long of long_text on a fresh server (stream_fn as
    make_server takes it; None: the port's stream) → an iterator of the
    PCM parts as they arrive."""
    from vallex_tpu_torch.server import DynamicBatcher, make_server

    batcher = DynamicBatcher(max_batch=4, max_wait_ms=50)
    srv = make_server("127.0.0.1", 0, batcher=batcher, stream_fn=stream_fn)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        body = json.dumps({"text": long_text, "prompt": prompt, "language": "en",
                           "seed": 0}).encode()
        url = f"http://127.0.0.1:{srv.server_address[1]}/synthesize-long"
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=240) as r:
            if r.status != 200:
                fail(f"5h /synthesize-long: status {r.status}")
            while True:
                part = r.read1(1 << 16)
                if not part:
                    break
                yield part
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.shutdown()
        th.join(30)


def timed_run(bundle, label: str, waves) -> dict:
    """Drain `waves` (an iterator of waves or PCM parts) → host seconds to
    the first and the last item, the samples, every sentence's codes (from
    the recorded handles) and the first wave's parts: the seconds before
    sentence 0's dispatch, its dispatch (AR + tail enqueue), and from
    there to the first wave; then the seconds of GC pauses before the
    first wave and the caching allocator's device allocations in the run."""
    import gc

    import numpy as np
    import torch

    pauses = []

    def gc_clock(_phase, _info):
        pauses.append(time.perf_counter())

    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    gc.callbacks.append(gc_clock)
    try:
        with dispatches(bundle) as calls:
            t0 = time.perf_counter()
            marks, samples = [], 0
            for w in waves:
                marks.append(time.perf_counter() - t0)
                if isinstance(w, bytes):  # PCM s16le, parted anywhere
                    samples += len(w) / 2
                elif np.isfinite(w).all():
                    samples += len(w)
                else:
                    fail(f"5h {label}: a wave that is not finite")
    finally:
        gc.callbacks.remove(gc_clock)
    first = marks[0] if marks else float("inf")
    gc_s = sum(b - a for a, b in zip(pauses[::2], pauses[1::2]) if b - t0 < first)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
    codes = [h.result().codes for _, _, h in calls]
    if not calls or samples != sum(len(c) for c in codes) * 320:
        fail(f"5h {label}: {samples} samples for {[len(c) for c in codes]} frames")
    (a, b, _) = calls[0]
    return {"first": marks[0], "last": marks[-1], "codes": codes,
            "enqueue": [h.result().seconds["enqueue"] for *_, h in calls],
            "parts": (a - t0, b - a, marks[0] - (b - t0), gc_s, allocs)}


def same_codes(label, got, want) -> None:
    import numpy as np

    if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if not np.array_equal(a, b)), min(len(got), len(want)))
        fail(f"5h {label}: codes differ from the sequential loop's at sentence {first}"
             f" ({[len(c) for c in got]} vs {[len(c) for c in want]} frames)")


def overlap_trace(api, bundle, sentences, prompt: str, card: str):
    """One torch.profiler trace of the overlapped batch loop (fixed-prompt,
    seed 0; the kernel path's batched route bypassed): the card's busy
    share over the call, the tail kernels on the second
    stream (flash forwards among them), and the share of each tail's device
    time that lies inside the next sentence's AR span → its codes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fixed = api._load_prompt(prompt)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("vallex.long_text"):
            codes = api._long_text_codes(bundle, sentences, fixed, "en", "no-accent",
                                         "fixed-prompt", None, 0)
        torch.cuda.synchronize()
    events = trace_events(prof)
    device = device_events(events)
    ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("vallex."))
    call = [(a, b) for a, b, n in ann if n == "vallex.long_text"]
    ars = [(a, b) for a, b, n in ann if n == "vallex.ar"]
    nars = [(a, b) for a, b, n in ann if n == "vallex.nar"]
    if not device or not call or len(ars) != len(sentences) or len(nars) != len(sentences):
        fail(f"5h trace: {len(device)} device events, spans {len(call)} / {len(ars)} /"
             f" {len(nars)}")
    lo, hi = call[0]
    busy = busy_ms([(a, b) for a, b, *_ in device], lo, hi)
    tails = [launched_in(events, device, a, b) for a, b in nars]
    ar_streams = {d[3] for a, b in ars for d in launched_in(events, device, a, b)}
    tail_streams = {d[3] for t in tails for d in t}
    flash_tail = [d for t in tails for d in t if "flash_fwd" in d[2]]
    if not flash_tail or {d[3] for d in flash_tail} & ar_streams:
        fail(f"5h trace: flash forwards on the tail stream {len(flash_tail)}, tail streams"
             f" {sorted(map(str, tail_streams))}, AR streams {sorted(map(str, ar_streams))}")
    inside = []
    for i, t in enumerate(tails[:-1]):
        dev_ms = sum(b - a for a, b, *_ in t) / 1e3
        nxt = ars[i + 1]
        hid = sum(max(0.0, min(b, nxt[1]) - max(a, nxt[0])) for a, b, *_ in t) / 1e3
        inside.append((round(hid, 3), round(dev_ms, 3)))
    say("trace " + json.dumps({
        "request": f"overlapped long text, {len(sentences)} sentences, {PROMPT_5H} tiled to"
                   f" {PROMPT_5H_FRAMES} frames, fixed-prompt, seed 0,"
                   f" {sum(len(c) for c in codes)} frames",
        "wall_ms_traced": round((hi - lo) / 1e3, 3), "device_busy_ms": round(busy, 3),
        "busy_share_traced": round(busy / ((hi - lo) / 1e3), 4),
        "tail_kernels": sum(len(t) for t in tails),
        "tail_kernels_off_the_ar_stream": sum(d[3] not in ar_streams for t in tails for d in t),
        "flash_fwd_on_tail_stream": len(flash_tail),
        "streams": {"ar": sorted(map(str, ar_streams)), "tail": sorted(map(str, tail_streams))},
        "tail_ms_inside_next_ar_of_tail_ms": inside}) + f"  [{card}]")
    return codes


def long_text_overlap(api, bundle, card: str) -> None:
    """Phase 5h, long text: 4 sentences with fuxuan's prompt tiled to 1980
    frames (C = 2304, every fixed-prompt tail runs the flash forward),
    default sampling. Seed 0 (no coin slides, so both modes keep the
    prompt): the overlapped stream against the script's sequential loop,
    PAIRS_5H pairs each for stream_audio_from_long_text and for POST
    /synthesize-long (there the sequential loop is the server's stream_fn),
    the pairs' order alternated; the overlapped batch loop in fixed-prompt
    mode, and the same under torch.profiler. Seed 3 (sentence 3 on
    sentence 2's codes): the stream against the sequential loop. One
    sequential run and one POST come first, untimed. Every
    overlapped run's codes equal the sequential loop's, bitwise. A route's
    overlapped first wave may not come later than its sequential one by
    more than the spread of its sequential first waves (the median of the
    paired differences)."""
    import numpy as np

    sentences = api.split_text_into_sentences(LONG_5H)
    if len(sentences) < 4:
        fail(f"5h: {len(sentences)} sentences")
    coins = np.random.RandomState(0).rand(len(sentences))
    if (coins < 0.5).any():
        fail(f"5h: seed 0 draws coins {coins.tolist()}")
    slides = np.random.RandomState(SLIDE_SEED).rand(len(sentences))[:-1] < 0.5
    if not slides.any():
        fail(f"5h: seed {SLIDE_SEED} slides at no sentence")
    med = statistics.median
    r4 = lambda xs: [round(x, 4) for x in xs]  # noqa: E731
    td = tempfile.mkdtemp(prefix="vallex-5h-")
    try:
        prompt = tiled_prompt(api, td)
        routes = {
            "stream_audio_from_long_text": (
                lambda: sequential_waves(api, bundle, LONG_5H, prompt, "sliding-window", 0),
                lambda: api.stream_audio_from_long_text(LONG_5H, prompt, language="en",
                                                        mode="sliding-window", seed=0)),
            "POST /synthesize-long": (
                lambda: server_waves(LONG_5H, prompt, lambda text, **kw: sequential_waves(
                    api, bundle, text, kw["prompt"], kw["mode"], kw["seed"])),
                lambda: server_waves(LONG_5H, prompt)),
        }
        # untimed, each run's first use: the tail stream's allocations, a
        # server's handler thread, the stream's worker thread
        ref = timed_run(bundle, "warm-up, sequential loop", routes[
            "stream_audio_from_long_text"][0]())["codes"]
        same_codes("warm-up, POST /synthesize-long", timed_run(
            bundle, "warm-up", routes["POST /synthesize-long"][1]())["codes"], ref)
        enq = []
        for route, (seq_fn, ovl_fn) in routes.items():
            pairs = []
            for k in range(PAIRS_5H):
                runs = {}
                for kind in (("seq", "ovl") if k % 2 == 0 else ("ovl", "seq")):
                    runs[kind] = timed_run(bundle, f"{route} ({kind})",
                                           (seq_fn if kind == "seq" else ovl_fn)())
                    same_codes(f"{route} ({kind}, pair {k})", runs[kind]["codes"], ref)
                    enq += runs[kind]["enqueue"]
                pairs.append((runs["seq"], runs["ovl"]))
            seq, ovl = [p[0] for p in pairs], [p[1] for p in pairs]
            diff = [o["first"] - s["first"] for s, o in pairs]
            noise = max(s["first"] for s in seq) - min(s["first"] for s in seq)
            say(f"  long text, {len(sentences)} sentences, {PROMPT_5H} tiled to"
                f" {PROMPT_5H_FRAMES} frames, seed 0 ({sum(len(c) for c in ref)} frames, codes"
                f" bitwise equal), {route}, {PAIRS_5H} pairs, seq/ovl then ovl/seq in turn:"
                f" sequential first wave {med([s['first'] for s in seq]):.4f} s (runs"
                f" {r4([s['first'] for s in seq])}), last {med([s['last'] for s in seq]):.4f} s"
                f" (runs {r4([s['last'] for s in seq])}); overlapped first wave"
                f" {med([o['first'] for o in ovl]):.4f} s (runs {r4([o['first'] for o in ovl])}),"
                f" last {med([o['last'] for o in ovl]):.4f} s (runs"
                f" {r4([o['last'] for o in ovl])}); first wave overlapped - sequential by pair"
                f" {r4(diff)}, median {med(diff):.4f} s, noise (the sequential first waves'"
                f" spread) {noise:.4f} s  [{card}]")
            say(f"  {route}, sentence 0 (seconds before its dispatch, its AR + tail enqueue,"
                f" from there to the first wave; GC pauses before it, s; device allocations in"
                f" the run): sequential {[r4(s['parts']) for s in seq]},"
                f" overlapped {[r4(o['parts']) for o in ovl]}")
            if med(diff) > noise:
                fail(f"5h {route}: the overlapped first wave came later than the sequential"
                     f" loop's by {r4(diff)} s (median {med(diff):.4f}), beyond the noise"
                     f" {noise:.4f} s")
        slid = {kind: timed_run(bundle, f"seed {SLIDE_SEED} ({kind})", fn()) for kind, fn in (
            ("seq", lambda: sequential_waves(api, bundle, LONG_5H, prompt, "sliding-window",
                                             SLIDE_SEED)),
            ("ovl", lambda: api.stream_audio_from_long_text(
                LONG_5H, prompt, language="en", mode="sliding-window", seed=SLIDE_SEED)))}
        same_codes(f"stream_audio_from_long_text, sliding-window, seed {SLIDE_SEED}",
                   slid["ovl"]["codes"], slid["seq"]["codes"])
        t0 = time.perf_counter()
        codes = api._long_text_codes(bundle, sentences, api._load_prompt(prompt), "en",
                                     "no-accent", "fixed-prompt", None, 0)
        t_batch = time.perf_counter() - t0
        same_codes("batch loop, fixed-prompt", codes, ref)
        say(f"  sliding-window, seed {SLIDE_SEED} (slides after sentences"
            f" {np.flatnonzero(slides).tolist()}; {[len(c) for c in slid['seq']['codes']]}"
            f" frames, codes bitwise equal): sequential loop last wave"
            f" {slid['seq']['last']:.4f} s, overlapped stream {slid['ovl']['last']:.4f} s;"
            f" overlapped batch loop, fixed-prompt, seed 0: {t_batch:.4f} s  [{card}]")
        say(f"  host time to enqueue a tail (NAR + Vocos, C = 2304): median"
            f" {med(enq) * 1e3:.3f} ms, max {max(enq) * 1e3:.3f} ms over {len(enq)} sentences"
            f"  [{card}]")
        same_codes("traced batch loop, fixed-prompt",
                   overlap_trace(api, bundle, sentences, prompt, card), ref)
    finally:
        shutil.rmtree(td, ignore_errors=True)


ZOO_AR_CAP, ZOO_TTS_FRAMES = 512, 200  # bf16 at full width, timed
ZOO_F32_CAP, ZOO_F32_MELS = 64, 16  # f32 on the card against the CPU


def model_zoo(dev, card: str) -> None:
    """Phase 5h, the rest of the model zoo at the shipped width (d 1024,
    16 heads, FFN 4096) cut to LATER_LAYERS layers a stack (random weights
    from seed 0):
    VALL-F's AR (greedy and sampled over a 512-frame buffer, a 384-frame
    prompt) and its NAR,
    the Transformer TTS's inference (up to 200 frames) in bf16, timed; then
    f32 (TF32 off) at a short cap against the same calls on the CPU: greedy
    tokens, NAR codes and mel frame counts equal, mels at 1e-4 of their
    scale."""
    import numpy as np
    import torch

    from vallex_tpu_torch.config import ModelConfig
    from vallex_tpu_torch.models import get_model
    from vallex_tpu_torch.models import transformer_tts as TT
    from vallex_tpu_torch.models import vallf as VF

    cfg = dataclasses.replace(ModelConfig(), num_layers=LATER_LAYERS)
    rng = np.random.RandomState(0)
    # a 384-frame prompt: the AR generates up to 127 frames into the buffer
    S, TP = 60, ZOO_AR_CAP * 3 // 4
    text = np.zeros((1, 128), np.int64)
    text[0, :S] = rng.randint(5, 500, S)
    prompt = rng.randint(0, 1024, (ZOO_AR_CAP, 8))

    def nar_input(y, gl, tp, t_audio):
        codes = np.zeros((1, t_audio, 8), np.int64)
        codes[0, :tp] = prompt[:tp]
        codes[0, tp:tp + gl, 0] = y[0, tp + 1:tp + 1 + gl].cpu().numpy()
        return codes

    init_f, _ = get_model("VALL-F", cfg)
    tree = init_f(cfg, torch.Generator().manual_seed(0))
    m = VF.build(tree, cfg, device=dev, dtype=torch.bfloat16)
    cb0 = prompt[None, :TP, 0]
    VF.vallf_ar_generate(m, cfg, text, S, cb0, TP, t_audio=TP + 8, dtype=torch.bfloat16)  # warm
    (y, gl), t_ar = synced(dev, lambda: VF.vallf_ar_generate(
        m, cfg, text, S, cb0, TP, t_audio=ZOO_AR_CAP, dtype=torch.bfloat16))
    gen = y[0, TP + 1:TP + 1 + gl]
    if not (gl > 0 and int(gen.min()) >= 0 and int(gen.max()) <= cfg.eos_id):
        fail(f"5h VALL-F greedy AR: {gl} frames, tokens in [{int(gen.min())}, {int(gen.max())}]")
    card_time(f"VALL-F AR greedy, bf16, {gl} frames over a {ZOO_AR_CAP}-frame buffer"
              f" ({gl / t_ar:.1f} frames/s)", t_ar, card)
    g = torch.Generator(device=dev).manual_seed(0)
    (ys, gls), t_s = synced(dev, lambda: VF.vallf_ar_generate(
        m, cfg, text, S, cb0, TP, t_audio=ZOO_AR_CAP, greedy=False, generator=g,
        dtype=torch.bfloat16))
    if not (0 < gls <= ZOO_AR_CAP - 1 - TP and ys.shape == (1, ZOO_AR_CAP)):
        fail(f"5h VALL-F sampled AR: {gls} frames, buffer {tuple(ys.shape)}")
    card_time(f"VALL-F AR sampled, bf16, {gls} frames", t_s, card)
    glc = min(gl, ZOO_AR_CAP - TP - 1)
    codes_in = nar_input(y, glc, TP, ZOO_AR_CAP)
    codes, t_nar = synced(dev, lambda: VF.vallf_nar_generate(
        m, cfg, text, S, codes_in, TP + glc, TP, dtype=torch.bfloat16))
    c = codes.cpu().numpy()
    if not (c.shape == (1, ZOO_AR_CAP, 8) and np.array_equal(c[0, :TP], prompt[:TP])
            and c.min() >= 0 and c.max() < 1024 + 1):
        fail(f"5h VALL-F NAR: codes {c.shape} in [{c.min()}, {c.max()}]")
    card_time(f"VALL-F NAR, bf16, 7 stages over {ZOO_AR_CAP} frames", t_nar, card)

    # f32, TF32 off (main() turns it off), against the CPU
    tp32 = 32
    m32 = VF.build(tree, cfg, device=dev, dtype=torch.float32)
    mc = VF.build(tree, cfg, device="cpu", dtype=torch.float32)
    del m, tree
    cb32 = prompt[None, :tp32, 0]
    (yg, glg), t_g = synced(dev, lambda: VF.vallf_ar_generate(
        m32, cfg, text, S, cb32, tp32, t_audio=ZOO_F32_CAP))
    t0 = time.perf_counter()
    yc, glc32 = VF.vallf_ar_generate(mc, cfg, text, S, cb32, tp32, t_audio=ZOO_F32_CAP)
    t_cpu = time.perf_counter() - t0
    if glg != glc32 or not np.array_equal(yg.cpu().numpy(), yc.numpy()):
        diff = np.nonzero(yg.cpu().numpy()[0] != yc.numpy()[0])[0]
        fail(f"5h VALL-F f32 greedy: {glg} frames on the card, {glc32} on the CPU, first"
             f" differing position {diff[:1].tolist()}")
    n_in = nar_input(yc, glc32, tp32, ZOO_F32_CAP)
    ng = VF.vallf_nar_generate(m32, cfg, text, S, n_in, tp32 + glc32, tp32).cpu().numpy()
    nc = VF.vallf_nar_generate(mc, cfg, text, S, n_in, tp32 + glc32, tp32).numpy()
    if not np.array_equal(ng, nc):
        fail(f"5h VALL-F f32 NAR: {int((ng != nc).sum())} codes differ from the CPU's")
    say(f"  VALL-F f32 (buffer {ZOO_F32_CAP}, prompt {tp32}): greedy tokens ({glg} frames) and"
        f" NAR codes on the card equal the CPU's ({t_g:.3f} s on the card, AR {t_cpu:.1f} s"
        f" on the CPU)")
    del m32, mc

    # the Transformer TTS: random weights fire the stop head within a frame
    # or two, so the timed run (and one f32 check) also takes a copy whose
    # stop bias is -100, which runs every frame
    init_t, _ = get_model("Transformer", cfg)
    tree = init_t(cfg, torch.Generator().manual_seed(0))
    quiet = dict(tree, stop_layer={"w": tree["stop_layer"]["w"], "b": torch.full((1,), -100.0)})
    tts = TT.build(quiet, cfg, device=dev, dtype=torch.bfloat16)
    TT.inference(tts, cfg, text, S, max_frames=8, dtype=torch.bfloat16)  # warm
    (mels, n), t_tts = synced(dev, lambda: TT.inference(
        tts, cfg, text, S, max_frames=ZOO_TTS_FRAMES, dtype=torch.bfloat16))
    if not (n == ZOO_TTS_FRAMES and torch.isfinite(mels).all()):
        fail(f"5h Transformer TTS: {n} frames, finite {bool(torch.isfinite(mels).all())}")
    card_time(f"Transformer TTS inference, bf16, {n} frames (stop bias -100)", t_tts, card)
    mel_t = torch.from_numpy(rng.randn(2, ZOO_TTS_FRAMES, 100).astype(np.float32))
    (loss, parts), t_fwd = synced(dev, lambda: TT.forward(
        tts, cfg, np.repeat(text, 2, 0), np.array([S, S - 10]), mel_t,
        np.array([ZOO_TTS_FRAMES, ZOO_TTS_FRAMES - 40]), dtype=torch.bfloat16))
    if not torch.isfinite(loss):
        fail(f"5h Transformer TTS forward: loss {float(loss)}")
    card_time(f"Transformer TTS forward (batch 2, {ZOO_TTS_FRAMES} frames), loss"
              f" {float(loss):.4f}", t_fwd, card)
    del tts
    for label, t in (("random stop head", tree), ("stop bias -100", quiet)):
        mg, n_g = TT.inference(TT.build(t, cfg, device=dev), cfg, text, S,
                               max_frames=ZOO_F32_MELS)
        mc, n_c = TT.inference(TT.build(t, cfg, device="cpu"), cfg, text, S,
                               max_frames=ZOO_F32_MELS)
        mg, mc = mg.cpu().numpy(), mc.numpy()
        scale = float(np.abs(mc).max())
        err = float(np.abs(mg - mc).max())
        if n_g != n_c or err > 1e-4 * scale:
            fail(f"5h Transformer TTS f32, {label}: {n_g} frames on the card, {n_c} on the"
                 f" CPU, mels {err:.3e} apart (scale {scale:.3e})")
        say(f"  Transformer TTS f32, {label}: {n_g} of {ZOO_F32_MELS} frames on the card and"
            f" the CPU, mels within {err:.3e} (1e-4 of their scale {scale:.3e})")


# ---------------------------------------------------------------------------
# The gradio UI, multi-GPU serving and dp × tp training (phase 5i):
# module-level so each step reads only what it is handed.
# ---------------------------------------------------------------------------

UI_PORT = 7861
TP2_PARAMS = 215_266_308  # per rank at tp = 2, as each JAX device holds (PERF.md §6)


def stub_gradio():
    """A stand-in `gradio` (not installed on the card) that records the
    UI's clicks and its launch → the record."""
    import types

    rec = {"clicks": {}, "launch": None, "tab": None}

    class Comp:
        def __init__(self, *args, **kwargs):
            self.args = args

        def click(self, fn, inputs, outputs):
            rec["clicks"][rec["tab"]] = (fn, len(inputs), len(outputs))

    class Ctx(Comp):
        def __enter__(self):
            if self.args and isinstance(self.args[0], str):
                rec["tab"] = self.args[0]
            return self

        def __exit__(self, *exc):
            rec["tab"] = None
            return False

        def launch(self, **kwargs):
            rec["launch"] = kwargs

    gr = types.ModuleType("gradio")
    gr.Blocks = gr.Tab = Ctx
    for name in ("Markdown", "TextArea", "Audio", "Dropdown", "File", "Button"):
        setattr(gr, name, Comp)
    sys.modules["gradio"] = gr
    return rec


def ui_paths(dev, api, bundle, card: str, td: str) -> None:
    """The four tabs' callbacks of vallex_tpu_torch/ui.py (best_of 5) on the
    full-width bundle, through a stub gradio: each returns (24000, a finite
    wave), "Make prompt" its .npz, and launch got the port."""
    import numpy as np

    from vallex_tpu_torch.ui import launch_ui
    from vallex_tpu_torch.utils.audio import save_wav

    rec = stub_gradio()
    try:
        launch_ui(port=UI_PORT)
    finally:
        sys.modules.pop("gradio", None)
    if rec["launch"] != {"server_port": UI_PORT} or len(rec["clicks"]) != 4:
        fail(f"5i UI: launch {rec['launch']}, {len(rec['clicks'])} tabs wired")
    t = np.arange(3 * 24000) / 24000.0
    clip = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
            + 0.02 * np.random.RandomState(0).randn(len(t))).astype(np.float32)
    wav = os.path.join(td, "ui_clip.wav")
    save_wav(wav, clip)
    said = "Hello world, this is a test."
    calls = [("Infer from prompt", ("Hello world.", "paimon", "en", "no-accent")),
             ("Infer from audio", ("Hello world.", wav, said, "auto-detect", "no-accent")),
             ("Long text", ("One sentence here. Another one there.", "paimon", "fixed-prompt")),
             ("Make prompt", ("smoke_ui", wav, said))]
    cwd = os.getcwd()
    os.chdir(td)  # "Make prompt" writes ./customs
    try:
        for tab, args in calls:
            fn, n_in, n_out = rec["clicks"][tab]
            if n_in != len(args) or n_out != 1:
                fail(f"5i UI {tab}: {n_in} inputs, {n_out} outputs")
            out, secs = synced(dev, lambda: fn(*args))
            if tab == "Make prompt":
                if not (isinstance(out, str) and os.path.exists(out)):
                    fail(f"5i UI {tab}: {out!r}")
                desc = os.path.relpath(out, td)
            else:
                sr, wave = out
                if sr != 24000 or wave.ndim != 1 or not len(wave) or not np.isfinite(wave).all():
                    fail(f"5i UI {tab}: rate {sr}, wave {wave.shape}, finite "
                         f"{bool(np.isfinite(wave).all())}")
                desc = f"{len(wave) / 24000:.2f} s of audio"
            card_time(f"5i UI '{tab}' ({desc})", secs, card)
    finally:
        os.chdir(cwd)
    say(f"  UI: 4 tabs wired, launch(server_port={UI_PORT}); every callback ran (best_of 5)")


KERNELS = ("gemm_small_m", "masked_attention", "sample_epilogue")  # in every serving worker
TRAIN_FLASH = ("flash_attention_fwd@", "flash_attention_bwd_dq@",
               "flash_attention_bwd_dkv@")  # in every training rank


def serving_paths(dev, api, bundle, card: str) -> None:
    """batch_synthesize on a mesh of two worker processes that share the
    card, at full width, greedy: per_chip=1 (paimon's prompt and none)
    bitwise equal to pipeline.synthesize in this process at the batch's
    buckets; per_chip=2 (4 requests) bitwise equal to this process's batched
    route on each chunk; each worker's launches by site."""
    import dataclasses

    import numpy as np

    from vallex_tpu_torch.engine import batch as BT
    from vallex_tpu_torch.parallel.mesh import make_mesh

    cfg, ecfg = bundle.cfg, dataclasses.replace(bundle.ecfg, top_k=1, decode_mode="auto")

    def request(text, prompt):
        audio, text_prompt, lang = api._load_prompt(prompt)
        ids, langs = api._prepare_text(bundle, text, text_prompt, lang, "en", "no-accent")
        return ids, langs, (audio if len(audio) else None)

    def launched(tag, launches):
        for w, counts in enumerate(launches):
            missing = [k for k in KERNELS if not any(s.startswith(k + "@") for s in counts)]
            if missing:
                fail(f"5i serving {tag}: worker {w} launched no {missing}: {counts}")
            say(f"  serving {tag}, worker {w} launches by site: {json.dumps(dict(sorted(counts.items())))}")

    reqs = [request("Hello world.", "paimon"), request("Hello world.", None)]
    with make_mesh(2, 1, [str(dev)] * 2) as mesh:
        got, t_first = synced(dev, lambda: BT.batch_synthesize(
            bundle.model, cfg, ecfg, mesh, reqs, decode_mode="auto"))
        launched("per_chip=1", mesh.serving.last_launches)
        worker_s = list(mesh.serving.last_seconds)
        pids = [c.proc.pid for c in mesh.serving.children]
        pb = BT.pad_batch(cfg, ecfg, reqs)
        buckets = (pb["s_text"], pb["p_audio"], pb["t_audio"])

        def parent():
            return [bundle.pipeline.synthesize(t, lg, p, top_k=1, seed=i, return_wave=False,
                                               buckets=buckets).codes
                    for i, (t, lg, p) in enumerate(reqs)]

        want, t_parent = synced(dev, parent)
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not (g == w).all():
                fail(f"5i serving per_chip=1 request {i}: {g.shape} vs this process's {w.shape}")
        say(f"  serving per_chip=1: 2 requests ({[len(g) for g in got]} frames) bitwise equal to"
            f" pipeline.synthesize here at the batch's buckets {buckets}")
        card_time("5i batch_synthesize per_chip=1, 2 workers (the call starts the pool)",
                  t_first, card)
        card_time(f"5i   (the two workers' own seconds: {[round(s, 4) for s in worker_s]})",
                  max(worker_s), card)
        card_time("5i pipeline.synthesize of the same 2 requests in this process", t_parent,
                  card)

        reqs4 = [request("Hello world.", "paimon"), request("Good morning.", None),
                 request("Thank you very much.", "paimon"), request("See you soon.", None)]
        got4, t4 = synced(dev, lambda: BT.batch_synthesize(
            bundle.model, cfg, ecfg, mesh, reqs4, per_chip=2, decode_mode="auto"))
        launched("per_chip=2", mesh.serving.last_launches)
        if [c.proc.pid for c in mesh.serving.children] != pids:
            fail("5i serving: the second call did not reuse the workers")
        worker_s4 = list(mesh.serving.last_seconds)
        pb4 = BT.pad_batch(cfg, ecfg, reqs4, per_chip=2)
        local = BT.make_chunked_synthesis(
            bundle.model, cfg, ecfg, make_mesh(1, 1, [str(dev)]), s_text=pb4["s_text"],
            p_audio=pb4["p_audio"], t_gen=pb4["t_gen"], t_audio=pb4["t_audio"], per_chip=2)
        keys = ("text", "lang", "x_lens", "prompt_cb0", "prompt_codes", "prompt_lens", "caps",
                "seeds")

        def chunks():
            out = []
            for c in (0, 1):
                codes, gl = local(*[pb4[k][2 * c: 2 * c + 2] for k in keys])
                out += [codes[r, p: p + n] for r, (p, n) in enumerate(
                    zip(pb4["prompt_lens"][2 * c: 2 * c + 2], gl))]
            return out

        want4, t_local = synced(dev, chunks)
        for i, (g, w) in enumerate(zip(got4, want4)):
            if g.shape != w.shape or not (g == w).all():
                fail(f"5i serving per_chip=2 request {i}: {g.shape} vs this process's {w.shape}")
        say(f"  serving per_chip=2: 4 requests ({[len(g) for g in got4]} frames) bitwise equal to"
            " this process's batched route on each chunk of 2")
        card_time("5i batch_synthesize per_chip=2, 2 workers x 2 requests (the same workers)",
                  t4, card)
        card_time(f"5i   (the two workers' own seconds: {[round(s, 4) for s in worker_s4]})",
                  max(worker_s4), card)
        card_time("5i the batched route of both chunks in this process", t_local, card)
        procs = [c.proc for c in mesh.serving.children]
    if any(p.poll() is None for p in procs):
        fail("5i serving: a worker outlived its mesh")
    say("  (two workers share one card: no speedup over one process is expected)")


def gib(n) -> str:
    return "not measured" if n is None else f"{n / 2**30:.3f} GiB"


def train_ranks(dev, model, cfg, card: str, td: str):
    """A generator: its first step takes the single-process steps in this
    process and starts the launches held to them, its second joins the
    launches and holds them. dp × tp training at full width from `model`'s
    weights (as f32), on 5f's batch (T = 1024, flash kernels): the
    single-process steps (a world of one here: f32 with TF32 off, then
    bf16, written to files) against (dp 2, tp 1) and (dp 1, tp 2), each
    two gloo ranks sharing the card, and one NCCL rank (a world of 1
    through the launcher: its f32 step), the three launches at once and
    beside the caller's other work. bf16: loss within 1e-2 (5f's route
    tolerance); at dp 2 every gradient leaf's cosine to the single
    process's bf16 one >= 0.999; at both meshes every leaf's cosine to the
    single process's f32 gradient no more than 1e-4 below the single
    process's own bf16 one (at tp 2 the product halves round apart, and
    12 + 12 layers carry that as far as bf16's own rounding carries the
    single process from f32: PERF.md §6). f32: loss within 1e-5
    relative, and the AdamW update of the single process's gradients
    within 1e-5 of the tree's largest parameter; the NCCL rank's loss
    within 1e-6 relative and its gradients' cosines >= 1 - 1e-6."""
    import torch

    from vallex_tpu_torch.convert import tree_from_module
    from vallex_tpu_torch.data.dataset import collate
    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.parallel.collectives import Group, TensorParallel
    from vallex_tpu_torch.parallel.launch import run_ranks
    from vallex_tpu_torch.parallel.mesh import Ranks, make_mesh
    from vallex_tpu_torch.train.distributed import StepJob, calls, step_job

    batch = {k: v for k, v in collate(utterances(0, TRAIN_TEXT, TRAIN_AUDIO)).items()
             if k != "utt_ids"}
    opt = dict(optimizer="adamw", base_lr=1e-4)
    f32 = dict(dtype="float32", use_flash=True, draws=(3, 40, None), **opt)
    bf = dict(f32, dtype="bfloat16")
    ref_32, ref_bf = os.path.join(td, "ref-f32.pt"), os.path.join(td, "ref-bf16.pt")
    tree = os.path.join(td, "tree.pt")  # every rank reads it memory-mapped

    def tensors(node):
        return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in node.items()}

    torch.save(tensors(tree_from_module(model)), tree)
    # the single process: a world of one in this process (its groups hold
    # one rank, so no collective runs); this process's launch counts kept
    t0 = time.perf_counter()
    counts = dict(loader.launch_counts)
    one = Ranks(make_mesh(1, 1, [str(dev)]), 0, dev, Group(None, 1, 0),
                TensorParallel(None, 1, 0))
    ref = calls(one, [(step_job, StepJob(cfg, tree, batch, save_to=ref_32, **f32)),
                      (step_job, StepJob(cfg, tree, batch, save_to=ref_bf, save=("grads",),
                                         compare_to=ref_32, **bf))])
    loader.launch_counts.clear()
    loader.launch_counts.update(counts)
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    l32, lbf = ref[0]["metrics"]["loss"], ref[1]["metrics"]["loss"]
    own = ref[1]["compare"]["grads"]  # the single process's bf16 gradients against its f32
    say(f"  the single process (this one): f32 loss {l32:.6f}, bf16 loss {lbf:.5f}; its bf16"
        f" gradients' cosine to its f32 ones >= {min(c for c, _, _ in own.values()):.6f}; host"
        f" seconds by stage (f32, bf16 jobs)"
        f" {[{k: round(v, 2) for k, v in j['seconds'].items()} for j in ref]}")
    card_time("5i the single-process f32 and bf16 steps here, files written", t_ref, card)
    scale = max(float(t.abs().max())
                for t in torch.load(ref_32, mmap=True, weights_only=True)["params"].values())
    nccl = "nccl" if dev.type == "cuda" else "gloo"
    meshes = ((2, 1), (1, 2))
    runs = {}

    def launch(key, mesh, todo, backend):
        t0 = time.perf_counter()
        runs[key] = run_ranks(mesh, calls, todo, backend=backend, threads=2, timeout=150)
        runs[key + ("s",)] = time.perf_counter() - t0

    launches = [threading.Thread(target=launch, args=(
        (dp, tp), make_mesh(dp, tp, [str(dev)] * 2),
        [(step_job, StepJob(cfg, tree, batch, compare_to=[ref_bf, ref_32], **bf)),
         (step_job, StepJob(cfg, tree, batch, compare_to=ref_32, **f32)),
         (step_job, StepJob(cfg, tree, {}, grads=ref_32, compare_to=ref_32, **opt))],
        "gloo")) for dp, tp in meshes]
    launches.append(threading.Thread(target=launch, args=(
        (1, 1), make_mesh(1, 1, [str(dev)]),
        [(step_job, StepJob(cfg, tree, batch, compare_to=ref_32, **f32))], nccl)))
    t0 = time.perf_counter()
    for t in launches:
        t.start()
    yield  # the caller's other work runs beside the launches
    for t in launches:
        t.join()
    t_all = time.perf_counter() - t0
    if (1, 1) not in runs:
        fail("5i: the world of 1 did not finish")
    ((w1,),) = runs[(1, 1)]
    g1 = w1["compare"]["grads"]
    w_g1 = min(g1, key=lambda k: g1[k][0])
    if abs(w1["metrics"]["loss"] - l32) > 1e-6 * abs(l32) or g1[w_g1][0] < 1 - 1e-6:
        fail(f"5i the {nccl} world of 1: f32 loss {w1['metrics']['loss']} vs {l32} here,"
             f" gradient cosine {g1[w_g1][0]} ({w_g1})")
    say(f"  one {nccl} rank (world of 1) through the launcher: f32 loss"
        f" {w1['metrics']['loss']:.6f} (here {l32:.6f}), gradient cosine to this process's >="
        f" {g1[w_g1][0]:.8f}; host seconds by stage {[{k: round(v, 2) for k, v in w1['seconds'].items()}]}")
    card_time("5i the world of 1: start, an f32 step, compare (beside the rest)",
              runs[(1, 1, "s")], card)
    for dp, tp in meshes:
        tag = f"(dp {dp}, tp {tp})"
        if (dp, tp) not in runs:
            fail(f"5i {tag}: the launch did not finish")
        outs = runs[(dp, tp)]
        c_bf, c_32, c_up = outs[0]
        if abs(c_bf["metrics"]["loss"] - lbf) > 1e-2 * abs(lbf):
            fail(f"5i {tag} bf16 loss {c_bf['metrics']['loss']} vs the single process's {lbf}")
        if abs(c_32["metrics"]["loss"] - l32) > 1e-5 * abs(l32):
            fail(f"5i {tag} f32 loss {c_32['metrics']['loss']} vs the single process's {l32}")
        to_bf, to_32 = (c["grads"] for c in c_bf["compare"])
        w_bf = min(to_bf, key=lambda k: to_bf[k][0])
        if dp == 2 and to_bf[w_bf][0] < 0.999:
            fail(f"5i {tag} bf16 gradient cosine {to_bf[w_bf][0]} ({w_bf})")
        lag = {k: own[k][0] - to_32[k][0] for k in own}
        w_lag = max(lag, key=lag.get)
        if lag[w_lag] > 1e-4:
            fail(f"5i {tag} bf16 gradient of {w_lag}: cosine {to_32[w_lag][0]} to the single"
                 f" process's f32 one, the single process's bf16 {own[w_lag][0]}")
        g32 = c_32["compare"]["grads"]
        w32 = min(g32, key=lambda k: g32[k][0])
        upd = c_up["compare"]["params"]
        w_up = max(upd, key=lambda k: upd[k][1])
        if upd[w_up][1] > 1e-5 * scale:
            fail(f"5i {tag} AdamW update of the same gradients: {w_up} {upd[w_up][1]:.3e} apart"
                 f" (1e-5 of {scale:.3e})")
        for r, per in enumerate(outs):
            counts = per[0]["launches"]
            if not all(any(k.startswith(n) for k in counts) for n in TRAIN_FLASH):
                fail(f"5i {tag} rank {r}: flash forward / backward not launched: {counts}")
            if tp == 2 and per[0]["local_params"] != TP2_PARAMS:
                fail(f"5i {tag} rank {r} holds {per[0]['local_params']} parameters, not"
                     f" {TP2_PARAMS}")
            say(f"  {tag} rank {r}: {per[0]['local_params']} parameters, peak"
                f" {gib(per[0]['peak_bytes'])} (bf16 step), {gib(per[1]['peak_bytes'])} (f32"
                f" step), launches by site {json.dumps(dict(sorted(counts.items())))}; host"
                f" seconds by stage (bf16, f32, AdamW jobs)"
                f" {[{k: round(v, 2) for k, v in j['seconds'].items()} for j in per]}  [{card}]")
        if tp == 2 and outs[0][0]["replicated"] != outs[1][0]["replicated"]:
            fail(f"5i {tag}: replicated leaves differ between the tp ranks")
        say(f"  {tag}: bf16 loss {c_bf['metrics']['loss']:.5f} (single {lbf:.5f}); bf16 gradient"
            f" cosine to the single process's bf16 >= {to_bf[w_bf][0]:.6f} ({w_bf}), to its f32"
            f" at most {lag[w_lag]:.2e} below the single process's bf16 ({w_lag}:"
            f" {to_32[w_lag][0]:.6f} vs {own[w_lag][0]:.6f}); f32 loss"
            f" {c_32['metrics']['loss']:.6f} (single {l32:.6f}), gradient cosine >="
            f" {g32[w32][0]:.8f} ({w32}); the AdamW update of the single process's f32"
            f" gradients within {upd[w_up][1]:.3e} ({w_up}; 1e-5 of {scale:.3e})")
        card_time(f"5i {tag}: start two ranks, three steps, compare (beside the rest)",
                  runs[(dp, tp, "s")], card)
    card_time("5i the three launches, from their start (beside the UI and serving)", t_all,
              card)


def multi_paths(dev, api, bundle, model, card: str) -> None:
    """Phase 5i (see ui_paths, serving_paths, train_ranks): the UI and
    serving on `bundle`, the training from `model` (the shipped depth);
    the training's launches run beside the UI and serving parts (their
    time is mostly their processes' start; the UI and serving times carry
    that load)."""
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        training = train_ranks(dev, model, model.cfg, card, td)
        next(training)
        t1 = time.perf_counter()
        ui_paths(dev, api, bundle, card, td)
        t2 = time.perf_counter()
        serving_paths(dev, api, bundle, card)
        t3 = time.perf_counter()
        next(training, None)
        t4 = time.perf_counter()
    card_time(f"5i parts: the single-process steps {t1 - t0:.2f} s, UI {t2 - t1:.2f} s,"
              f" serving {t3 - t2:.2f} s, the rest of training {t4 - t3:.2f} s; whole",
              t4 - t0, card)


# ---------------------------------------------------------------------------
# The native host runtime (phase 5j): module-level so it runs alone too.
# ---------------------------------------------------------------------------

HOST_SENTENCES = {
    "en": "Hello world, this is the native tokenizer on the card.",
    "zh": "你好，这是显卡上的原生分词器。",
    "ja": "こんにちは、これはカードの上のトークナイザーです。",
}
# the Chinese sentence's phonemes (the port's cje_cleaners with jieba), for
# a machine without jieba, where Chinese G2P cannot run
ZH_PHONEMES = ("ni↓↑xɑʊ↓↑,_ts`⁼ə↓s`ɹ`↓_ʃjɛn↓↑kʰa↓↑_s`ɑŋ↓_t⁼ə_ɥæn↑s`əŋ→_fən→tsʰɹ↑tʃʰi↓.")


def write_float_wav(path: str, samples, sr: int) -> None:
    """samples [n, channels] float32 as an IEEE-float RIFF/WAVE (format tag
    3), which the stdlib `wave` module cannot write or read."""
    import numpy as np

    data = np.ascontiguousarray(samples, "<f4")
    n_ch = data.shape[1]
    fmt = struct.pack("<HHIIHH", 3, n_ch, sr, sr * n_ch * 4, n_ch * 4, 32)
    body = b"WAVEfmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack(
        "<I", data.nbytes) + data.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def host_median(fn, reps=20) -> float:
    """Median host seconds of fn over reps (after one untimed call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def host_ms(label: str, secs: float, card: str) -> None:
    say(f"  time {label}: {secs * 1e3:.4f} ms  [{card}]")


def native_host_paths(dev, api, bundle, card: str) -> None:
    """Phase 5j, the native host runtime (vallex_tpu_torch/native.py): the
    library built from a clean _build/ (its build seconds); tokenize against
    the plain lookup on an English, a Chinese and a Japanese sentence; a 3 s
    float32 44.1 kHz stereo clip and a 3 s 16-bit 16 kHz clip decoded
    against the plain versions (int: bitwise the stdlib path; float: the
    double mean in numpy; the resampler within 1e-6 of its numpy formula)
    and made into prompts with EnCodec on the card (225 frames, codes equal
    to the same make_prompt on the CPU under rvq_parted's tie rule); host
    times: _prepare_text a language (median of 20), encode through the C++
    and through the lookup, load_wav of a 10 s 44.1 kHz clip through the
    C++ and through wave + resample_poly."""
    import copy
    import importlib.util

    import numpy as np
    import torch
    from scipy.signal import resample_poly

    from vallex_tpu_torch import native
    from vallex_tpu_torch.codec import encodec as EC
    from vallex_tpu_torch.frontend.cleaners import cje_cleaners
    from vallex_tpu_torch.frontend.tokenizer import lookup_ids
    from vallex_tpu_torch.utils.audio import load_wav, read_wav_plain, resample_plain, save_wav

    # ---- the build, from a clean _build/
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    native._lib = None
    t0 = time.perf_counter()
    native.library()
    t_build = time.perf_counter() - t0
    gxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True).stdout
    card_time(f"native library built from a clean _build/ ({gxx.splitlines()[0]},"
              f" {' '.join(native.CXX_FLAGS)})", t_build, card)

    # ---- tokenize against the plain lookup; _prepare_text and encode times
    has_jieba = importlib.util.find_spec("jieba") is not None
    _, text_prompt, lang_pr = api._load_prompt("paimon")
    for lang, text in HOST_SENTENCES.items():
        if lang == "zh" and not has_jieba:
            phonemes = ZH_PHONEMES
        else:
            marked = f"[{lang.upper()}]{text}[{lang.upper()}]"
            phonemes = cje_cleaners(marked)[0].replace(" ", "_")
        ids = native.tokenize(phonemes)
        if ids.tolist() != lookup_ids(phonemes):
            fail(f"5j tokenize ({lang}): {ids.tolist()} vs the lookup's {lookup_ids(phonemes)}")
        t_cpp = host_median(lambda: bundle.tokenizer.encode(phonemes))
        t_py = host_median(lambda: lookup_ids(phonemes))
        say(f"  tokenize ({lang}, {len(phonemes)} phonemes): equal to the lookup")
        host_ms(f"encode ({lang}, {len(phonemes)} phonemes) through the C++, median of 20",
                t_cpp, card)
        host_ms(f"encode ({lang}) through the dict lookup, median of 20", t_py, card)
        if lang == "zh" and not has_jieba:
            say(f"  _prepare_text (zh): not measured (no jieba here) [{card}]")
            continue
        t_prep = host_median(lambda: api._prepare_text(bundle, text, text_prompt, lang_pr, lang))
        host_ms(f"_prepare_text ({lang}, paimon's prompt text), median of 20", t_prep, card)

    td = tempfile.mkdtemp(prefix="vallex-5j-")
    try:
        # ---- two 3 s clips against the plain versions
        rng = np.random.RandomState(5)

        def tones(sr, secs, ch):
            t = np.arange(int(sr * secs)) / sr
            x = [0.3 * np.sin(2 * np.pi * (220 + 110 * c) * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
                 + 0.02 * rng.randn(len(t)) for c in range(ch)]
            return np.stack(x, 1).astype(np.float32)

        x44 = tones(44100, 3, 2)
        p44 = os.path.join(td, "float-44k-stereo.wav")
        write_float_wav(p44, x44, 44100)
        p16 = os.path.join(td, "int16-16k.wav")
        save_wav(p16, tones(16000, 3, 1)[:, 0], 16000)
        d44, sr44 = native.load_wav(p44)
        if sr44 != 44100 or not np.array_equal(
                d44, (x44.astype(np.float64).sum(1) / 2).astype(np.float32)):
            fail(f"5j load_wav float32 stereo: rate {sr44}, samples differ from the double mean")
        d16, sr16 = native.load_wav(p16)
        plain16, _ = read_wav_plain(p16)
        if sr16 != 16000 or not np.array_equal(d16.view(np.int32), plain16.view(np.int32)):
            fail(f"5j load_wav int16: rate {sr16}, samples not bitwise the stdlib path's")
        for label, d, sr in (("float32 44.1 kHz stereo", d44, 44100), ("int16 16 kHz", d16, 16000)):
            got = native.resample(d, sr, 24000)
            want = resample_plain(d, sr, 24000)
            err = float(np.abs(got - want).max())
            if got.shape != (72000,) or want.shape != (72000,) or err > 1e-6:
                fail(f"5j resample ({label}): {got.shape} / {want.shape}, max err {err:.3e}")
            say(f"  load_wav ({label}, 3 s): decoded as the plain version; resampled to 72000"
                f" samples, max abs err {err:.3e} to the numpy formula")

        # ---- make_prompt on the card, then the same call on the CPU
        enc_cpu = copy.deepcopy(bundle.encodec).to("cpu")
        cpu_bundle = dataclasses.replace(bundle, encodec=enc_cpu, device=torch.device("cpu"))
        for name, path in (("float44", p44), ("int16", p16)):
            api._bundle = bundle
            out_gpu, t_mp = synced(dev, lambda: api.make_prompt(
                f"gpu-{name}", path, transcript="Hello world, this is a test.", out_dir=td))
            api._bundle = cpu_bundle
            out_cpu = api.make_prompt(f"cpu-{name}", path, transcript="Hello world, this is a"
                                      " test.", out_dir=td)
            G, C = np.load(out_gpu), np.load(out_cpu)
            if G["audio_tokens"].shape != (1, 225, 8) or not np.array_equal(
                    G["text_tokens"], C["text_tokens"]):
                fail(f"5j make_prompt ({name}): {G['audio_tokens'].shape},"
                     f" text ids equal {np.array_equal(G['text_tokens'], C['text_tokens'])}")
            x = torch.from_numpy(load_wav(path)[0][None])
            lat = EC.encode_latent(enc_cpu, x).numpy()
            parted = rvq_parted(G["audio_tokens"], C["audio_tokens"], lat,
                                enc_cpu.codebooks.detach().numpy(),
                                label=f"5j make_prompt ({name})")
            say(f"  make_prompt ({name}): 225 frames, codes on the card equal the CPU call's"
                f" but {parted} frames parted at a near tie (rel {RVQ_TIE})")
            host_ms(f"make_prompt of 3 s ({name}: load_wav, G2P, EnCodec on the card)", t_mp,
                    card)
        api._bundle = bundle

        # ---- load_wav of 10 s at 44.1 kHz: the C++ against wave + resample_poly
        p10 = os.path.join(td, "int16-44k-10s.wav")
        save_wav(p10, tones(44100, 10, 1)[:, 0], 44100)

        def stdlib_poly():
            d, sr = read_wav_plain(p10)
            return resample_poly(d, 80, 147).astype(np.float32)

        if load_wav(p10)[0].shape != stdlib_poly().shape:
            fail("5j load_wav of 10 s: the C++ and resample_poly give different lengths")
        host_ms("load_wav of 10 s at 44.1 kHz (16-bit) through the C++, median of 5",
                host_median(lambda: load_wav(p10), reps=5), card)
        host_ms("the same through wave + resample_poly, median of 5",
                host_median(stdlib_poly, reps=5), card)
    finally:
        api._bundle = bundle
        shutil.rmtree(td, ignore_errors=True)


# ---------------------------------------------------------------------------
# The hybrid AR (phase 5k): module-level so it runs alone too, after the
# build (phases 1-2): python3 -c "import chip_smoke; chip_smoke.hybrid_alone()"
# ---------------------------------------------------------------------------

HYBRID_SITE = "decode_block_hybrid"
# kernels/ssm_step.cu's launches a decode step of the published stack (36
# Mamba-2 and 4 attention layers, a SwiGLU MLP after each): per Mamba layer
# one conv_step and one ssm_step; RMSNorm rows before each mixer and MLP,
# after each Mamba layer's gate and before the head; gemm_small_m two
# products a mixer, two an MLP, and the head
HYBRID_PER_STEP = {"ssm_step": 36, "conv_step": 36, "rms_norm_rows": 40 + 36 + 40 + 1,
                   "swiglu_rows": 40, "gemm_small_m": 36 * 2 + 4 * 2 + 40 * 2 + 1,
                   "masked_attention": 4, "sample_epilogue": 1}


def hybrid_kernel_checks(entry, dev) -> None:
    """kernels/ssm_step.cu's four kernels against their plain versions at
    the cell's widths (48 rows; 64 heads of 64 × 128 f32 state; conv_dim
    4,352; RMSNorm rows of 2,048 and 4,096; a SwiGLU of 8,192), each twice
    bitwise and the states in place (ssm_step's state within 1e-5, its y
    within 1e-4; conv_step's output within 1e-5 and its state bitwise;
    RMSNorm and SwiGLU rows within 1e-5), then grouped-K/V masked_attention
    (8 K/V heads × 4 query heads) as the hybrid block calls it; each timed
    against its plain version for one decode step's launches, with its
    bound from its bytes."""
    import math

    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.kernels import ssm_step as SK
    from vallex_tpu_torch.kernels.masked_attention import attention_bounds
    from vallex_tpu_torch.models.granite_hybrid import dt_bias_from

    g = torch.Generator(device=dev).manual_seed(28)
    M, H, P, N, D, F = 48, 64, 64, 128, 2048, 8192
    inner, Cd = H * P, H * P + 2 * N
    NM = HYBRID_PER_STEP["ssm_step"]

    def close(label, got, want, tol):
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            fail(f"{label}@{HYBRID_SITE}: max err {err:.3e} beyond {tol:g} (abs and rel)")
        return err

    zd = torch.randn((M, inner + Cd + H), generator=g, device=dev)
    xbc = torch.randn((M, Cd), generator=g, device=dev)
    S0 = torch.randn((M, H, P, N), generator=g, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt_bias = dt_bias_from(torch.exp(lo + torch.rand(H, generator=g, device=dev) * (hi - lo)))
    A_log = torch.log(1 + 15 * torch.rand(H, generator=g, device=dev))
    Dv = torch.ones(H, device=dev)
    kw = dict(z_off=0, dt_off=inner + Cd)
    S = S0.clone()
    _twice_bitwise("ssm_step", lambda: (SK.ssm_step(xbc, zd, S.copy_(S0), dt_bias, A_log, Dv,
                                                    site="check", **kw), S.clone()))
    Sp = S0.clone()
    y_p = SK.ssm_step_plain(xbc, zd, Sp, dt_bias, A_log, Dv, **kw)
    y = SK.ssm_step(xbc, zd, S.copy_(S0), dt_bias, A_log, Dv, site="check", **kw)
    torch.cuda.synchronize()
    err = max(close("ssm_step (state)", S, Sp, 1e-5), close("ssm_step (y)", y, y_p, 1e-4))
    # bytes a launch: the f32 state read and written; x, B, C, z, dt read; y written
    nbytes = 4 * M * (2 * H * P * N + H * P + 2 * N + H * P + H + H * P) + 12 * H
    entry("ssm_step", HYBRID_SITE, err,
          device_ms(lambda: [SK.ssm_step(xbc, zd, S, dt_bias, A_log, Dv, site="check", **kw)
                             for _ in range(NM)]),
          device_ms(lambda: [SK.ssm_step_plain(xbc, zd, S, dt_bias, A_log, Dv, **kw)
                             for _ in range(NM)]),
          NM * nbytes, NM * 5 * M * H * P * N, None,
          f"{NM} launches: one step's Mamba-2 updates, M={M}, {H} heads of {P} x {N}, f32 state",
          ops_per_s=F32_OPS_PER_S)

    st0 = torch.randn((M, 3, Cd), generator=g, device=dev)
    w = torch.randn((Cd, 4), generator=g, device=dev) * 0.5
    b = torch.randn(Cd, generator=g, device=dev) * 0.5
    st, st_p = st0.clone(), st0.clone()
    _twice_bitwise("conv_step", lambda: (SK.conv_step(zd, st.copy_(st0), w, b, x_off=inner,
                                                      site="check"), st.clone()))
    out_p = SK.conv_step_plain(zd, st_p, w, b, x_off=inner)
    out = SK.conv_step(zd, st.copy_(st0), w, b, x_off=inner, site="check")
    torch.cuda.synchronize()
    if not torch.equal(st, st_p):
        fail(f"conv_step@{HYBRID_SITE}: the shifted state differs from the plain version's")
    err = close("conv_step", out, out_p, 1e-5)
    # the state read and written, this step's x read, w and b, the output written
    nbytes = 4 * M * (2 * 3 * Cd + Cd + Cd) + 4 * 5 * Cd
    entry("conv_step", HYBRID_SITE, err,
          device_ms(lambda: [SK.conv_step(zd, st, w, b, x_off=inner, site="check")
                             for _ in range(NM)]),
          device_ms(lambda: [SK.conv_step_plain(zd, st, w, b, x_off=inner) for _ in range(NM)]),
          NM * nbytes, NM * 12 * M * Cd, None,
          f"{NM} launches: one step's width-4 convolutions, M={M}, {Cd} channels, f32 state",
          ops_per_s=F32_OPS_PER_S)

    # one step's RMSNorm rows: 81 of D (before each mixer and MLP, before
    # the head) and 36 of the inner width (each Mamba layer's gate)
    xd, xi = (torch.randn((M, k), generator=g, device=dev) for k in (D, inner))
    gd, gi = (torch.rand(k, generator=g, device=dev) + 0.5 for k in (D, inner))
    runs = [(xd, gd)] * (HYBRID_PER_STEP["rms_norm_rows"] - NM) + [(xi, gi)] * NM
    _twice_bitwise("rms_norm_rows", lambda: [SK.rms_norm_rows(x, gn, 1e-5, site="check")
                                             for x, gn in ((xd, gd), (xi, gi))])
    err = max(close("rms_norm_rows", SK.rms_norm_rows(x, gn, 1e-5, site="check"),
                    SK.rms_norm_rows_plain(x, gn, 1e-5), 1e-5) for x, gn in ((xd, gd), (xi, gi)))
    lib = getattr(Fn, "rms_norm", None)  # one PyTorch call on the same rows (torch >= 2.4)
    entry("rms_norm_rows", HYBRID_SITE, err,
          device_ms(lambda: [SK.rms_norm_rows(x, gn, 1e-5, site="check") for x, gn in runs]),
          device_ms(lambda: [SK.rms_norm_rows_plain(x, gn, 1e-5) for x, gn in runs]),
          sum(8 * x.numel() + 4 * gn.numel() for x, gn in runs),
          sum(4 * x.numel() for x, _ in runs),
          None if lib is None else device_ms(
              lambda: [lib(x, (x.shape[1],), gn, 1e-5) for x, gn in runs]),
          f"{len(runs)} launches: one step's RMSNorm rows, M={M}, f32 in and out",
          ops_per_s=F32_OPS_PER_S)

    x2 = torch.randn((M, 2 * F), generator=g, device=dev)
    NS = HYBRID_PER_STEP["swiglu_rows"]
    _twice_bitwise("swiglu_rows", lambda: [SK.swiglu_rows(x2, site="check")])
    err = close("swiglu_rows", SK.swiglu_rows(x2, site="check"), SK.swiglu_rows_plain(x2), 1e-5)
    entry("swiglu_rows", HYBRID_SITE, err,
          device_ms(lambda: [SK.swiglu_rows(x2, site="check") for _ in range(NS)]),
          device_ms(lambda: [SK.swiglu_rows_plain(x2) for _ in range(NS)]),
          NS * 12 * M * F, NS * 5 * M * F, None,
          f"{NS} launches: one step's SwiGLU rows, M={M}, F={F}, f32 in and out",
          ops_per_s=F32_OPS_PER_S)

    # grouped K/V as the block reads it: each of the 8 K/V heads once for
    # its 4 query heads (Tq = 4 at q_off 0), the cell's layout (text 256,
    # BOS + prompt 1,024, then the generated rows), prompts of 161-758 frames
    Hq, Hkv, hd, s_text, p_audio, t = 32, 8, 64, 256, 1024, 432
    C = s_text + p_audio + 1024 + 8
    qkv = torch.randn((M, (Hq + 2 * Hkv) * hd), generator=g, device=dev)
    q = qkv[:, : Hq * hd].view(M, Hkv, Hq // Hkv, hd)
    k = torch.randn((M, Hkv, C, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((M, Hkv, C, hd), generator=g, device=dev).to(torch.bfloat16)
    x_len = torch.randint(64, 200, (M,), generator=g, device=dev, dtype=torch.int32)
    plen = torch.randint(161, 759, (M,), generator=g, device=dev, dtype=torch.int32)
    bounds = attention_bounds(M, x_len=x_len, s_text=s_text, audio_len=plen + 1, q_off=0,
                              gen_lo=s_text + p_audio, gen_len=t + 1, device=dev)
    check_masked_attention(entry, HYBRID_SITE, q, k, v, bounds,
                           HYBRID_PER_STEP["masked_attention"])


def hybrid_tree(cfg, dev, seed: int = 0):
    """A random tree of `cfg` (the hybrid AR at its published widths)
    drawn on the card, the head's EOS column zeroed: the greedy rows then
    run to their caps (a zero logit is never the largest of 1,025)."""
    import torch

    from vallex_tpu_torch.models.vallex import init_vallex

    with torch.device(dev):
        tree = init_vallex(cfg, torch.Generator(device=dev).manual_seed(seed))
    tree["ar_predict_layer"]["w"][:, cfg.eos_id] = 0
    return tree


def hybrid_paths(dev, entries: list, card: str) -> dict:
    """Phase 5k: `hybrid_kernel_checks`, then the hybrid AR at the published
    widths (models/granite_hybrid.py; random weights on the card) through
    api.preload_models and SynthesisPipeline.synthesize_batch: 6 greedy
    requests, the AR block replayed as a CUDA graph, the codes bitwise the
    eager loop's. Launch counts are zeroed just before the graphed batch:
    at its site each kernel launched HYBRID_PER_STEP times a step run (K
    steps a replay), and at VALL-E X's sites only the NAR's flash forward,
    (quantizers - 1) x layers times. Appends this phase's rows to
    `entries` with their launches → the counts."""
    import numpy as np
    import torch

    from vallex_tpu_torch import api
    from vallex_tpu_torch.codec.vocos import init_vocos
    from vallex_tpu_torch.config import EngineConfig, HybridARConfig, ModelConfig
    from vallex_tpu_torch.engine import ar as AR
    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.models.granite_hybrid import state_bytes

    hybrid_kernel_checks(kernel_entry(entries), dev)
    cfg = ModelConfig(ar_stack=HybridARConfig())
    ecfg = EngineConfig(text_buckets=(256,), audio_buckets=(1024,), compute_dtype="bfloat16",
                        decode_steps=8, speculative="off")
    t0 = time.perf_counter()
    hb = api.preload_models(checkpoint_dir=os.path.join(REPO, "portbench", "none"),
                            params=hybrid_tree(cfg, dev), cfg=cfg, ecfg=ecfg, device=dev,
                            vocos_params=init_vocos(torch.Generator().manual_seed(1)))
    torch.cuda.synchronize()
    say(f"  hybrid AR bundle ({cfg.ar_stack.num_layers} layers at {cfg.ar_stack.hidden_size},"
        f" random weights on the card): "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(28)
    reqs = []
    for S, Tp in ((6, 0), (9, 161), (7, 300), (10, 758), (8, 40), (11, 500)):
        prompt = rng.randint(0, 1024, size=(Tp, 8)).astype(np.int32) if Tp else None
        reqs.append((rng.randint(5, 500, size=S).astype(np.int32), np.full(S, 0, np.int32),
                     prompt))
    want_len = [16 * len(t) for t, _, _ in reqs]  # each row's cap: 16 frames a phoneme
    pipe = hb.pipeline
    real = AR._graphed
    try:
        AR._graphed = lambda t: False
        eager = pipe.synthesize_batch(reqs, top_k=1, seed=3)
    finally:
        AR._graphed = real
    loader.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.synthesize_batch(reqs, top_k=1, seed=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(loader.launch_counts)
    sec, K, blocks = res.seconds, ecfg.decode_steps, res.ar.iterations
    if sec["ar_graph_blocks"] != blocks or blocks < 2 or eager.seconds["ar_graph_blocks"]:
        fail(f"5k: {sec['ar_graph_blocks']} graphed blocks of {blocks}; eager run"
             f" {eager.seconds['ar_graph_blocks']}")
    lens = [len(c) for c, _ in res.outputs]
    same = np.array_equal(res.ar.y_gen, eager.ar.y_gen) and all(
        np.array_equal(a, b) for (a, _), (b, _) in zip(res.outputs, eager.outputs))
    if lens != want_len or not same:
        fail(f"5k: graphed lengths {lens} (caps {want_len}); codes bitwise the eager loop's:"
             f" {same}")
    if not all(w is not None and np.isfinite(w).all() for _, w in res.outputs):
        fail("5k: a request's wave is missing or not finite")
    for kernel, per in HYBRID_PER_STEP.items():
        got = counts.get((kernel, HYBRID_SITE), 0)
        if got != per * K * blocks:
            fail(f"5k: {kernel}@{HYBRID_SITE} launched {got} times, want {per} x {K} x {blocks}")
    # the NAR: the flash forward at every layer of its 7 stages (C = 1,280);
    # VALL-E X's decode launches nothing here
    nar = {("flash_attention_fwd", "flash_attention_batched"):
           (cfg.num_quantizers - 1) * cfg.num_layers}
    at_vallex = {(k, s): n for (k, s), n in counts.items() if s in TPU and s != HYBRID_SITE}
    if at_vallex != nar:
        fail(f"5k: launches at VALL-E X's sites: {at_vallex}; want the NAR's {nar}")
    say(f"  graphed batch of {len(reqs)} (greedy, lengths {lens}) in {wall:.2f} s: codes"
        f" bitwise the eager loop's; {blocks} blocks replayed, AR prefill"
        f" {sec['ar_prefill']:.3f} s (scans {sec['ar_scan']:.3f} s), decode"
        f" {sec['ar_decode']:.3f} s ({1e3 * sec['ar_decode'] / (K * blocks):.2f} ms a step),"
        f" state {sec['ar_state_bytes']:.0f} B (= {state_bytes(cfg, len(reqs))}); {card}")
    say(f"  phase 5k launches by site: "
        f"{json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts.items())})}")
    for e in entries:
        kernel, site = e["name"].split("@")
        if site == HYBRID_SITE:
            e["launches"] = counts.get((kernel, site), 0)
    api._bundle = None
    del hb, pipe
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The NAR at the offline benchmark cells' shape (phase 3g): module-level so it
# runs alone too, after the build: python3 -c "import chip_smoke; chip_smoke.nar_alone()"
# ---------------------------------------------------------------------------

# the cells' batch (portbench/traffic/offline-b48): 48 rows; text bucket 256
# with 82-256 valid phonemes, audio bucket 1024 with 1022 valid frames (every
# request runs to its cap), prompts of the presets' 161-758 frames
NAR_CELL = dict(rows=48, s_text=256, x_len=(82, 256), t_audio=1024, t_len=1022,
                prompt_len=(161, 758))


def nar_cell_check(dev, model, entry=None, seed: int = 29) -> dict:
    """nar_generate on the card at NAR_CELL's shape, bf16, `model` (VALL-E X
    at the shipped width, 12 layers: 16 heads of 64, or 8 of 128), random
    inputs from `seed`. Fails unless
    - every layer's attention is the flash forward at flash_attention_batched:
      exactly (quantizers - 1) x layers launches (84), no other launch, and
      no call of the masked core (`models.layers.attention_core`);
    - each launch's output on the valid rows lies within `flash_rows_rule`
      of the masked core's f32 output on the same q, k, v under the NAR's
      additive mask (the core rounds p to bf16 once, as the kernel does);
    - in stage order, each stage's codes on the generated rows are as
      accurate as the masked core's: against the same stage in f32
      arithmetic (an f32 copy of `model`, the masked core), on the same
      input (teacher-forced on the flash route's earlier stages), the
      flash route's codes differ at no more rows than the masked core's
      codes do, plus 3 sqrt(n), n the rows where the two bf16 routes
      differ. Each such row moves the difference by at most one, so two
      routes of equal accuracy pass but for a 3-sigma draw. (The two bf16
      routes differ at ~0.7% of rows, almost all where the masked core's
      two best logits lie within one bf16 ulp + 1e-5 of max|logits|, but
      at 0-2 rows a seed a little beyond: PERF.md §6; printed.)
    With `entry`, times the kernel at this shape beside the masked core and
    SDPA (PERF.md's row k1280; a variant row, kept out of the `kernels`
    line) → the counts and errors."""
    import collections
    import copy
    import math

    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.engine import nar as NAR
    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.models import layers as L
    from vallex_tpu_torch.models import vallex as V

    cfg = model.cfg
    R, S, TA = NAR_CELL["rows"], NAR_CELL["s_text"], NAR_CELL["t_audio"]
    C, H, hd = S + TA, cfg.num_heads, cfg.head_dim
    g = torch.Generator().manual_seed(seed)
    x_len = torch.randint(NAR_CELL["x_len"][0], NAR_CELL["x_len"][1] + 1, (R,), generator=g)
    prompt_len = torch.randint(NAR_CELL["prompt_len"][0], NAR_CELL["prompt_len"][1] + 1, (R,),
                               generator=g)
    t_len = torch.full((R,), NAR_CELL["t_len"])
    text = torch.randint(5, 500, (R, S), generator=g)
    lang = torch.randint(0, 3, (R, S), generator=g)
    codes = torch.randint(0, 1024, (R, TA, 8), generator=g)
    x_len, prompt_len, t_len, text, lang, codes = (
        t.to(dev) for t in (x_len, prompt_len, t_len, text, lang, codes))
    ok = NAR.key_padding(S, TA, x_len, t_len, dev)
    mask = torch.where(ok, 0.0, V.NEG_INF)[:, None, None, :]
    rows_gen = torch.arange(TA, device=dev)[None, :]
    gen = (rows_gen >= prompt_len[:, None]) & (rows_gen < t_len[:, None])  # [R, TA]

    core, real_fwd, real_stage = L.attention_core, NAR.flash_attention_fwd, V.nar_forward_stage
    seen = dict(reference=False, core_calls=0, worst=0.0, err=0.0, beyond_ulp=0, elems=0,
                compared=0, flips=0, ties=0, off_f32_flash=0, off_f32_core=0, logit_err=0.0)
    m32 = copy.deepcopy(model).float()  # the same weights, f32 arithmetic

    def counted_core(q, k, v, m):
        if not seen["reference"]:
            seen["core_calls"] += 1
        return core(q, k, v, m)

    def checked_fwd(q, k, v, q_seg, kv_seg, prefix, *, site=""):
        out, lse = real_fwd(q, k, v, q_seg, kv_seg, prefix, site=site)
        ref = core(q.float(), k, v, mask)  # f32 out; p rounded to bf16 as the core does
        spread = core(q.float(), k, v.abs(), mask)
        diff, one_ulp, tol = flash_rows_rule(out, ref, spread, q_seg)
        seen["worst"] = max(seen["worst"], float((diff / tol).max()))
        seen["err"] = max(seen["err"], float(diff.max()))
        seen["beyond_ulp"] += int((diff > one_ulp).sum())
        seen["elems"] += diff.numel()
        del ref, spread, diff, one_ulp, tol
        return out, lse

    def checked_stage(m, xy, stage, stage_mask=None, attention=None, *a, **k):
        h = real_stage(m, xy, stage, stage_mask, attention, *a, **k)
        seen["reference"] = True
        try:
            h_ref = real_stage(m, xy, stage, mask, None)
            h32 = real_stage(m32, xy.float(), stage, mask, None)
        finally:
            seen["reference"] = False
        lf, lr = V.nar_logits(m, h[:, S:], stage), V.nar_logits(m, h_ref[:, S:], stage)
        af, ar, a32 = lf.argmax(-1), lr.argmax(-1), V.nar_logits(m32, h32[:, S:], stage).argmax(-1)
        top = lr.topk(2, dim=-1).values
        tie = (top[..., 0] - top[..., 1]) <= bf16_ulp(top[..., 0]) + 1e-5 * float(lr.abs().max())
        flip = (af != ar) & gen
        seen["compared"] += int(gen.sum())
        seen["flips"] += int(flip.sum())
        seen["ties"] += int((flip & tie).sum())
        seen["off_f32_flash"] += int(((af != a32) & gen).sum())
        seen["off_f32_core"] += int(((ar != a32) & gen).sum())
        seen["logit_err"] = max(seen["logit_err"], float((lf - lr).abs()[gen].max()))
        del h_ref, h32, lf, lr
        return h

    before = collections.Counter(loader.launch_counts)
    saved = (L.attention_core, NAR.flash_attention_fwd, V.nar_forward_stage)
    L.attention_core, NAR.flash_attention_fwd, V.nar_forward_stage = (
        counted_core, checked_fwd, checked_stage)
    try:
        with torch.inference_mode():
            out = NAR.nar_generate(model, cfg, text, lang, x_len, codes, t_len, prompt_len,
                                   dtype=torch.bfloat16)
            torch.cuda.synchronize()
    finally:
        L.attention_core, NAR.flash_attention_fwd, V.nar_forward_stage = saved
    counts = collections.Counter(loader.launch_counts)
    counts.subtract(before)
    counts = {k: n for k, n in counts.items() if n}
    want = {("flash_attention_fwd", "flash_attention_batched"):
            (cfg.num_quantizers - 1) * cfg.num_layers}
    seen["allowed"] = seen["off_f32_core"] + 3 * math.sqrt(max(seen["flips"], 1))
    where = f"3g NAR at the cells' shape, hd {hd}"
    if counts != want or seen["core_calls"]:
        fail(f"{where}: launches {counts}, want {want}; {seen['core_calls']} calls of the"
             f" masked core")
    if seen["worst"] > 1.0:
        fail(f"{where}: a flash output {seen['worst']:.3f} of the flash rows' bound from the"
             f" masked core's (max err {seen['err']:.3e})")
    codes_line = (
        f"stage codes: the two bf16 routes differ at {seen['flips']} of {seen['compared']} rows"
        f" ({seen['ties']} at a one-ulp tie; logits max err {seen['logit_err']:.3e}); against f32"
        f" arithmetic the flash route's differ at {seen['off_f32_flash']}, the masked core's at"
        f" {seen['off_f32_core']} (allowed {seen['allowed']:.1f})")
    if seen["off_f32_flash"] > seen["allowed"]:
        fail(f"{where}: {codes_line}")
    if out.shape != (R, TA, 8):
        fail(f"{where}: codes {tuple(out.shape)}")
    say(f"  3g nar_generate R={R}, C={S}+{TA}, hd {hd}, bf16: {want} flash launches, no masked"
        f" core; outputs within the flash rows' rule (worst {seen['worst']:.3f} of it; max err"
        f" {seen['err']:.3e}; {seen['beyond_ulp']} of {seen['elems']} beyond one ulp + 1e-5);"
        f" {codes_line}")
    if entry is not None:
        D = H * hd
        qkv = torch.randn((R, C, 3 * D), device=dev).to(torch.bfloat16)
        q, k, v = (qkv[..., i * D:(i + 1) * D].view(R, C, H, hd).transpose(1, 2)
                   for i in range(3))
        seg = ok.to(torch.int32).contiguous()
        lib_mask = (ok[:, :, None] == ok[:, None, :])[:, None]  # the segments' pairs
        pairs = int(lib_mask.sum()) * H  # as rows g and k count them
        kernel_ms = device_ms(lambda: real_fwd(q, k, v, seg, seg, C, site="check"))
        core_ms = device_ms(lambda: core(q, k, v, mask))
        lib_ms = device_ms(lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
        n = R * H * C * hd
        entry("flash_attention_fwd", "flash_attention_batched", seen["err"], kernel_ms, core_ms,
              4 * n * 2 + R * H * C * 4 + 2 * R * C * 4, 4 * hd * pairs, lib_ms,
              f"k1280: NAR at the cells' shape, B={R}, H={H}, hd={hd}, T={C}, bf16, segments"
              f" (ok, ok), prefix T; {int(ok.sum())} valid rows, {pairs} segment pairs; plain ="
              f" the masked core (attention_core) under the NAR's additive mask", False)
        seen.update(kernel_ms=kernel_ms, core_ms=core_ms, library_ms=lib_ms)
        del qkv, q, k, v, lib_mask
    del out, m32
    torch.cuda.empty_cache()
    return dict(seen, launches=counts)


def nar_alone() -> None:
    """Phases 1, 2 and 3g on their own: the shipped model, random weights
    from seed 0, timed; then its width at 8 heads of 128."""
    import torch

    sys.path.insert(0, REPO)
    from vallex_tpu_torch.config import ModelConfig
    from vallex_tpu_torch.convert import load_tree
    from vallex_tpu_torch.kernels import loader
    from vallex_tpu_torch.models.vallex import VALLE, init_vallex

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    with phase("1 card", 60):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
        say(card)
    with phase("2 build", 300):
        loader.build()
        loader.library()
    cfg = ModelConfig()
    model = load_tree(VALLE(cfg), init_vallex(cfg, torch.Generator().manual_seed(0)),
                      dtype=torch.bfloat16, device=dev)
    with phase("3g NAR at the cells' shape", 180):
        nar_cell_check(dev, model, kernel_entry([]))
        del model
        torch.cuda.empty_cache()
        cfg128 = dataclasses.replace(cfg, num_heads=8)
        model = load_tree(VALLE(cfg128), init_vallex(cfg128, torch.Generator().manual_seed(0)),
                          dtype=torch.bfloat16, device=dev)
        nar_cell_check(dev, model)


def hybrid_alone() -> None:
    """Phases 1, 2 and 5k on their own, then their `kernels` line."""
    import torch

    sys.path.insert(0, REPO)
    from vallex_tpu_torch.kernels import loader

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    with phase("1 card", 60):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
        say(card)
    with phase("2 build", 300):
        loader.build()
        loader.library()
    entries = []
    loader.reset_launch_counts()
    with phase("5k hybrid AR", 240):
        hybrid_paths(dev, entries, card)
    say(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "unit"} for e in entries]}))


# ---------------------------------------------------------------------------
# The decode products (phases 3-3d): module-level so that
# tools/torch_flash_bench.py times them for another tree too.
# ---------------------------------------------------------------------------

def gemm_calls(lw, M, g, act_quant=False):
    """The 49 products of one decode step at M rows of packed weights lw
    ([NL, N, K] a layer); act_quant: the 48 layer products W8A8, the head
    W8A16 (as the TPU kernels)."""
    import torch

    NL, D, F = lw["wqkv"].shape[0], lw["wqkv"].shape[2], lw["w1"].shape[1]
    dev = lw["wqkv"].device
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
    import torch

    from vallex_tpu_torch.kernels import gemm_small_m_plain

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


def int_mm_library_ms(calls, M, g):
    """torch._int_mm (int8 x int8 → int32, the integer product alone)
    per W8A8 product, the rows padded to 17: on CUDA it refuses 16 rows
    or fewer. None where this torch has no such kernel."""
    import torch

    dev = g.device
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


def check_gemm_products(entry, g, vocab, site, lw, M, unit, in_line=True, act_quant=False):
    """gemm_small_m against its plain version on the 49 products of one
    decode step at M rows: 1e-2 of the output scale (f32 weights: 1e-4),
    two runs bitwise equal, each row of M > 1 bitwise its M = 1 product,
    the head's argmax; then timed against the plain version and one library
    call per product (entry(...) takes the row)."""
    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.kernels import gemm_small_m, gemm_small_m_plain

    calls = gemm_calls(lw, M, g, act_quant)
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
        lib_ms = int_mm_library_ms(calls, M, g)
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


# ---------------------------------------------------------------------------
# The decode attention (phases 3-3d, 3f): module-level so that
# tools/torch_flash_bench.py times it for another tree too.
# ---------------------------------------------------------------------------

def check_masked_attention(entry, site, q, k, v, bounds, reps_layers, in_line=True,
                           prefix=None, beams=1, kv_scales=None, new_kv=None, slot=None):
    """The kernel against its plain version at 2e-5 (f32 softmax and sums on
    both sides, in another order), two runs bitwise equal; with a prefix,
    the grouped mode (row b reads the text and prompt keys of prefix b //
    beams); with kv_scales, int8 K/V; with new_kv and slot, the own-column
    mode, whose written column must equal the plain version's bitwise.
    Then its time against the plain version's and SDPA's (`entry`)."""
    import torch
    import torch.nn.functional as Fn

    from vallex_tpu_torch.kernels import masked_attention, masked_attention_plain
    from vallex_tpu_torch.kernels.masked_attention import valid_keys, with_prefix, write_column

    B, H, Tq, hd = q.shape
    dev = q.device
    own = new_kv is not None
    gk = dict(prefix=prefix, beams=beams, kv_scales=kv_scales, new_kv=new_kv, slot=slot)
    k_run, v_run = (k.clone(), v.clone()) if own else (k, v)  # own: the kernel writes
    outk = masked_attention(q, k_run, v_run, bounds, site="check", **gk).float()
    k_two, v_two = (k.clone(), v.clone()) if own else (k, v)
    again = masked_attention(q, k_two, v_two, bounds, site="check", **gk).float()
    # the plain version in f32 on the same (bf16- or int8-valued) inputs
    ref = masked_attention_plain(q.float(), k, v, bounds, **gk)
    torch.cuda.synchronize()
    if not torch.equal(outk, again):
        fail(f"masked_attention@{site}: two runs differ (max"
             f" {float((outk - again).abs().max())})")
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


DECODE_ROWS = ("b", "b32", "b128", "e", "e16", "e32", "e128", "i", "m", "n", "p", "q", "s")


def decode_attention_rows(entry, g, dev, names=DECODE_ROWS, NL=12) -> None:
    """PERF.md's decode-attention rows at the shapes of phases 3-3d and 3f
    (the shipped model: d_model 1024, 16 heads at hd 64, 8 at hd 128; a
    "Hello world." cache C = 2184 at draft position 600, the batch of four's
    C = 3208, best_of 1 x 5 and 4 x 5 over their prefixes, the int8 cache,
    the own-column steps), each through check_masked_attention against its
    plain version and SDPA. Random K/V and queries from the generator g."""
    import torch

    from vallex_tpu_torch.engine import ar as AR
    from vallex_tpu_torch.kernels.masked_attention import attention_bounds

    S_TEXT, X_LEN, POS0, T_AUDIO = 128, 50, 600, 2048
    C = S_TEXT + T_AUDIO + 8
    XL_B, PL_B, T_GEN, GEN = [20, 52, 90, 128], [0, 60, 400, 758], 2048, [600, 350, 1200, 90]
    P_AUDIO = -(-(max(PL_B) + 1) // AR.ABLK) * AR.ABLK
    C_B, BEAMS, PL1 = S_TEXT + P_AUDIO + T_GEN + 8, 5, 198  # PL1: paimon's prompt frames
    rows_i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    rep = lambda t: t.repeat_interleave(BEAMS)  # noqa: E731
    bf16 = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731

    def q_of(B, Tq, H=16, hd=64):  # a strided view of the QKV product, as the decode hands it
        qkv = torch.randn((B * Tq, 3 * H * hd), generator=g, device=dev)
        return qkv[:, :H * hd].view(B, Tq, H, hd).transpose(1, 2)

    def qkv_of(B, H=16, hd=64):  # q and the new k/v [B, H, 1, hd] views
        qkv = torch.randn((B, 3 * H * hd), generator=g, device=dev).view(B, 1, 3, H, hd)
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))

    def int8_pair(kc, vc):
        k8, v8, (ks, vs) = AR.int8_caches(kc[None], vc[None])
        return k8[0], v8[0], (ks[0].contiguous(), vs[0].contiguous())

    one = attention_bounds(1, x_len=X_LEN, s_text=S_TEXT, audio_len=POS0 + 1, q_off=1, device=dev)
    ck, cv = bf16(1, 16, C, 64), bf16(1, 16, C, 64)
    for name in names:
        if name in ("b", "b32", "e", "e16", "e32"):
            Tq = {"e": 8, "e16": 16, "e32": 8}.get(name, 1)
            f32 = name.endswith("32")
            site = "decode_block_fused" if Tq == 1 else "decode_verify"
            check_masked_attention(entry, site, q_of(1, Tq), ck.float() if f32 else ck,
                                   cv.float() if f32 else cv, one, NL)
        elif name in ("b128", "e128"):
            k8_, v8_ = bf16(1, 8, C, 128), bf16(1, 8, C, 128)
            Tq = 1 if name == "b128" else 8
            site = ("decode_block_fused" if Tq == 1 else "decode_verify") + HD128
            check_masked_attention(entry, site, q_of(1, Tq, 8, 128), k8_, v8_, one, NL)
        elif name == "i":
            kb, vb = bf16(4, 16, C_B, 64), bf16(4, 16, C_B, 64)
            bb = attention_bounds(4, x_len=rows_i32(XL_B), s_text=S_TEXT,
                                  audio_len=rows_i32(PL_B) + 1, q_off=1,
                                  gen_lo=S_TEXT + P_AUDIO, gen_len=rows_i32(GEN) + 1, device=dev)
            check_masked_attention(entry, "decode_block_fused_batched", q_of(4, 1), kb, vb, bb, NL)
        elif name == "m":
            pk, pv = bf16(1, 16, S_TEXT + 512, 64), bf16(1, 16, S_TEXT + 512, 64)
            kg, vg = bf16(BEAMS, 16, T_AUDIO + 8, 64), bf16(BEAMS, 16, T_AUDIO + 8, 64)
            b1 = attention_bounds(BEAMS, x_len=X_LEN, s_text=S_TEXT, audio_len=PL1 + 1, q_off=1,
                                  gen_lo=0, gen_len=rows_i32([POS0 + 1] * BEAMS), device=dev)
            check_masked_attention(entry, "decode_block_fused_beams", q_of(BEAMS, 1), kg, vg, b1,
                                   NL, prefix=(pk, pv), beams=BEAMS)
        elif name == "n":
            pk, pv = bf16(4, 16, S_TEXT + P_AUDIO, 64), bf16(4, 16, S_TEXT + P_AUDIO, 64)
            kg, vg = bf16(4 * BEAMS, 16, T_GEN + 8, 64), bf16(4 * BEAMS, 16, T_GEN + 8, 64)
            b4 = attention_bounds(4 * BEAMS, x_len=rep(rows_i32(XL_B)), s_text=S_TEXT,
                                  audio_len=rep(rows_i32(PL_B)) + 1, q_off=1, gen_lo=0,
                                  gen_len=rep(rows_i32(GEN)) + 1, device=dev)
            check_masked_attention(entry, "decode_block_fused_grouped", q_of(4 * BEAMS, 1), kg,
                                   vg, b4, NL, prefix=(pk, pv), beams=BEAMS)
        elif name == "p":
            k8, v8, sc8 = int8_pair(ck, cv)
            q, nk, nv = qkv_of(1)
            check_masked_attention(entry, "decode_block_fused_int8kv", q, k8, v8, one, NL,
                                   kv_scales=sc8, new_kv=(nk, nv), slot=S_TEXT + POS0)
        elif name in ("q", "s"):
            step_b = attention_bounds(1, x_len=X_LEN, s_text=S_TEXT, audio_len=POS0, q_off=0,
                                      device=dev)
            q, nk, nv = qkv_of(1)
            check_masked_attention(entry, "decode_attention" if name == "q" else "decode_step_fused",
                                   q, ck, cv, step_b, 1 if name == "q" else NL, new_kv=(nk, nv),
                                   slot=S_TEXT + POS0)
        else:
            fail(f"decode_attention_rows: no row {name}")


# ---------------------------------------------------------------------------
# The sampling epilogue (phases 3-3d): module-level so that
# tools/torch_flash_bench.py times it for another tree too.
# ---------------------------------------------------------------------------

def empty_launch_ms(dev):
    """The floor under every device_ms: a one-element fill_ and
    torch.cuda._sleep(1), timed by the same harness."""
    import torch

    z = torch.empty(1, device=dev)
    out = {"fill_": device_ms(lambda: z.fill_(0.0))}
    if hasattr(torch.cuda, "_sleep"):
        out["_sleep(1)"] = device_ms(lambda: torch.cuda._sleep(1))
    return out


def _same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


def _twice_bitwise(label, run) -> None:
    """Two launches on the same inputs give the same bits in every output."""
    first, second = run(), run()
    if not all(_same_bits(a, b) for a, b in zip(first, second)):
        fail(f"{label}: two runs differ")


def check_sample_epilogue(entry, g, dev, vocab, VP, site, rows, greedy, in_line=True):
    """The unfiltered epilogue (Gumbel or greedy) against its plain version on
    the same uniforms: tokens equal, logprobs at 1e-4, two runs bitwise."""
    import torch

    from vallex_tpu_torch.kernels import sample_epilogue, sample_epilogue_plain

    logits = torch.randn((rows, VP), generator=g, device=dev) * 3
    u = None if greedy else torch.rand((rows, VP), generator=g, device=dev)
    kw = dict(vocab=vocab, temperature=1.0, greedy=greedy)
    tk, lk = sample_epilogue(logits, u, site="check", **kw)
    tp, lp = sample_epilogue_plain(logits, u, **kw)
    torch.cuda.synchronize()
    if not torch.equal(tk, tp):
        fail(f"sample_epilogue@{site}: tokens differ {tk.tolist()} vs {tp.tolist()}")
    err = float((lk - lp).abs().max())
    if not err <= 1e-4:
        fail(f"sample_epilogue@{site}: logprob err {err}")
    _twice_bitwise(f"sample_epilogue@{site}",
                   lambda: sample_epilogue(logits, u, site="check", return_keep=True, **kw))
    ms = device_ms(lambda: sample_epilogue(logits, u, site="check", **kw))
    pms = device_ms(lambda: sample_epilogue_plain(logits, u, **kw))
    nbytes = rows * VP * 4 * (1 if greedy else 2) + rows * 8
    # library: null — no one PyTorch call computes the Gumbel-argmax (or
    # argmax) together with the chosen token's log-softmax logprob
    entry("sample_epilogue", site, err, ms, pms, nbytes, 4 * rows * VP, None,
          f"1 launch: {rows} x {VP} logits, {'greedy' if greedy else 'Gumbel'}", in_line)


def check_sample_rejects(dev) -> None:
    """The wrapper raises, before any launch, for what the kernel does not
    take: rows wider than VP_MAX, and logits off a 16-byte boundary."""
    import torch

    from vallex_tpu_torch.kernels.sample_epilogue import VP_MAX, sample_epilogue

    wide = torch.zeros((1, VP_MAX + 128), device=dev)
    shifted = torch.zeros((1, 1156), device=dev)[:, 1:1153]
    for name, x in (("a row wider than VP_MAX", wide), ("logits off 16 bytes", shifted)):
        try:
            sample_epilogue(x, None, vocab=x.shape[1], temperature=1.0, greedy=True, site="check")
        except ValueError:
            continue
        fail(f"sample_epilogue: {name} was not refused")


def check_filtered_epilogue(entry, g, dev, vocab, VP, rows, top_k, top_p, in_line=False,
                            temperature=1.0, ties=False, note=""):
    """The filtered epilogue against its plain version on the same uniforms:
    kept sets equal, except at a token whose mass above lies within 1e-5 of
    top_p (the f32 mass sums run in another order); tokens equal and
    logprobs at 1e-4 on every row whose kept set is equal; two runs
    bitwise. ties: 5 more lanes of each row take its k-th largest value.
    Returns the number of kept-set differences."""
    import torch

    from vallex_tpu_torch.kernels import sample_epilogue, sample_epilogue_plain
    from vallex_tpu_torch.ops.sampling import topk_keep_mask

    site = "decode_block_fused_filtered"
    logits = torch.randn((rows, VP), generator=g, device=dev) * 3
    if ties:
        kth = logits[:, :vocab].topk(top_k, dim=-1).values[:, -1:]
        lanes = torch.randperm(vocab, generator=g, device=dev)[:5]
        logits[:, lanes] = kth.expand(rows, 5)
    u = torch.rand((rows, VP), generator=g, device=dev)
    kw = dict(vocab=vocab, temperature=temperature, greedy=False, top_k=top_k, top_p=top_p)
    tk, lk, kk = sample_epilogue(logits, u, return_keep=True, site="check", **kw)
    tp, lp, kp = sample_epilogue_plain(logits, u, return_keep=True, **kw)
    torch.cuda.synchronize()
    diff = kk[:, :vocab] != kp[:, :vocab]
    if bool(diff.any()):
        lanes = torch.arange(VP, device=dev)
        scaled = torch.where(lanes < vocab, logits, -1e30) / max(temperature, 1e-6)
        f = torch.where(topk_keep_mask(scaled, top_k), scaled, -1e9).double()
        prob = torch.softmax(f, dim=-1)
        for r, i in diff.nonzero().tolist():
            above = float(prob[r][f[r] > f[r, i]].sum())
            if abs(above - top_p) > 1e-5:
                fail(f"sample_epilogue@{site}: row {r} token {i} kept differently, mass"
                     f" above {above} vs top_p {top_p}")
    boundary = int(diff.sum())
    same = ~diff.any(1)
    if not torch.equal(tk[same], tp[same]):
        fail(f"sample_epilogue@{site}: tokens differ {tk.tolist()} vs {tp.tolist()}")
    err = float((lk[same] - lp[same]).abs().max()) if bool(same.any()) else 0.0
    if not err <= 1e-4:
        fail(f"sample_epilogue@{site}: logprob err {err}")
    _twice_bitwise(f"sample_epilogue@{site} top_k={top_k} top_p={top_p}",
                   lambda: sample_epilogue(logits, u, return_keep=True, site="check", **kw))
    ms = device_ms(lambda: sample_epilogue(logits, u, site="check", **kw))
    pms = device_ms(lambda: sample_epilogue_plain(logits, u, **kw))
    nbytes = rows * VP * 4 * 2 + rows * 8
    # what the function needs per logit, not the algorithm that runs it: the
    # scale, one pass per filter (a compare for top-k; an exp, a sum and a
    # compare for top-p), the Gumbel draw (two logs, an add, the argmax
    # compare) and the log-softmax's exp and sum
    ops = rows * VP * (1 + 1 + 3 + 4 + 2)
    # library: null — no one PyTorch call filters, draws and returns the
    # chosen token's logprob
    entry("sample_epilogue", site, err, ms, pms, nbytes, ops, None,
          f"1 launch: {rows} x {VP} logits, top_k={top_k}, top_p={top_p}, T={temperature},"
          f" Gumbel{note}; {boundary} kept-set difference(s) at the nucleus boundary", in_line,
          F32_OPS_PER_S)
    return boundary


# PERF.md's filtered rows, (rows, top_k, top_p, temperature, ties): l (in the
# kernels line), the other three settings and the 20 rows of each; then the
# edge rows: l-p (top-p alone), top-k alone, k above the kernel's
# sorted-candidate cap, ties at the k-th value, temperature 0.7, 8 rows.
FILTERED_SETTINGS = tuple((rows, k, p, 1.0, False) for rows in (1, 20) for k in (10, 50)
                          for p in (0.9, 0.5))
FILTERED_EDGES = ((1, -100, 0.9, 1.0, False), (1, 50, 1.0, 1.0, False), (1, 200, 0.9, 1.0, False),
                  (1, 50, 0.9, 1.0, True), (8, 50, 0.9, 0.7, False), (8, 50, 0.9, 1.0, False),
                  (20, -100, 0.9, 1.0, False))
FILTERED_ROWS = FILTERED_SETTINGS + FILTERED_EDGES


# PERF.md's sample_epilogue rows by name, for tools/torch_decode_variants.py:
# (site, rows, greedy) unfiltered, (rows, top_k, top_p) filtered
SAMPLE_ROWS = {"c": ("decode_block_fused", 1, False), "f": ("decode_verify", 8, True),
               "j": ("decode_block_fused_batched", 8, False), "v": ("decode_step_fused", 1, False),
               "l": (1, 50, 0.9), "l20": (20, 50, 0.9), "l-p": (1, -100, 0.9),
               "l-k": (1, 50, 1.0), "l200": (1, 200, 0.9)}


def sample_rows(entry, g, dev, vocab, VP, names) -> None:
    """The SAMPLE_ROWS named, each checked and timed."""
    for name in names:
        a = SAMPLE_ROWS[name]
        if isinstance(a[0], str):
            check_sample_epilogue(entry, g, dev, vocab, VP, *a)
        else:
            check_filtered_epilogue(entry, g, dev, vocab, VP, *a)


def filtered_rows(entry, g, dev, vocab, VP, g_edges=None) -> int:
    """Every FILTERED_ROWS check, the edge rows' inputs from g_edges when
    given (so that they leave g's stream, which later phases draw from, as it
    was without them); the kept-set differences in all."""
    total = 0
    for rows, k, p, temp, ties in FILTERED_ROWS:
        gen = g_edges if g_edges is not None and (rows, k, p, temp, ties) in FILTERED_EDGES else g
        total += check_filtered_epilogue(entry, gen, dev, vocab, VP, rows, k, p,
                                         in_line=(rows, k, p, temp, ties) == (1, 50, 0.9, 1.0, False),
                                         temperature=temp, ties=ties,
                                         note=", ties at the k-th value" if ties else "")
    return total


def kernel_entry(entries: list):
    """The `entry(...)` every kernel check reports through: one measured
    row, appended to `entries` (the `kernels` line) unless in_line=False."""
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
    return entry


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the GPU")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as Fn

    from vallex_tpu_torch import api
    from vallex_tpu_torch.engine import ar as AR
    from vallex_tpu_torch.codec.encodec import init_encodec
    from vallex_tpu_torch.codec.vocos import init_vocos
    from vallex_tpu_torch.engine.pipeline import SynthesisPipeline
    from vallex_tpu_torch.kernels import (
        gemm_small_m, gemm_small_m_plain, loader, masked_attention,
        masked_attention_plain,
    )
    from vallex_tpu_torch.kernels.gemm_small_m import gemm_prep, gemm_prep_plain
    from vallex_tpu_torch.kernels.masked_attention import (
        attention_bounds, valid_keys, with_prefix, write_column,
    )
    from vallex_tpu_torch.ops.decode_attention import decode_attention
    from vallex_tpu_torch.ops.decode_block import decode_block_fused
    from vallex_tpu_torch.ops.decode_step import decode_step, decode_step_fused, pack_layer_weights
    from vallex_tpu_torch.models.vallex import init_vallex
    from vallex_tpu_torch.ops.decode_verify import decode_verify, embed
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

    entries = []
    entry = kernel_entry(entries)

    # ---- kernel checks -------------------------------------------------------
    def check_gemm(site, lw, M, unit, in_line=True, act_quant=False):
        check_gemm_products(entry, g, vocab, site, lw, M, unit, in_line, act_quant)

    def check_prep(site, lw, M, act_quant, in_line=True, dtype=torch.bfloat16):
        """The prep kernel of gemm_small_m (the prologue once per product)
        against its plain version, on the prologues of one decode step: the
        LayerNorm rows of QKV, FFN1 and the head, and with act_quant also
        the cast rows of out-proj and FFN2 (W8A8 quantizes every layer
        product). bf16 rows within one bf16 ulp of the plain version's (its
        LayerNorm sums run in another order); f32 rows (dtype float32, the
        f32 product's) within 1e-6 of each row's scale; W8A8 scales within
        1e-6 of theirs and codes at most one apart (the same rounding halves
        may fall either way after an f32 LayerNorm), bitwise equal for a
        cast."""
        f32 = dtype == torch.float32
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
            got = gemm_prep(x, ln=ln, act_quant=aq, dtype=dtype)
            ref = gemm_prep_plain(x, ln=ln, act_quant=aq, dtype=dtype)
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
            elif f32:
                e = (got - ref).abs()
                row_scale = ref.abs().amax(-1, keepdim=True)
                if not bool((e <= 1e-6 * row_scale).all()):
                    fail(f"gemm_small_m_prep@{site}: f32 rows beyond 1e-6 of their scale, max"
                         f" err {float(e.max())}")
                err = max(err, float(e.max()))
            else:
                e = (got.float() - ref.float()).abs()
                ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(2.0 ** -100))) - 7)
                if not bool((e <= ulp).all()):
                    fail(f"gemm_small_m_prep@{site}: bf16 rows beyond one ulp, max err {float(e.max())}")
                err = max(err, float(e.max()))
        ms = device_ms(lambda: [gemm_prep(x, ln=ln, act_quant=a, dtype=dtype)
                                for x, ln, a in runs])
        pms = device_ms(lambda: [gemm_prep_plain(x, ln=ln, act_quant=a, dtype=dtype)
                                 for x, ln, a in runs])
        # f32 rows read once, the LayerNorm's two vectors, the rows written
        nbytes = sum(x.numel() * 4 + (0 if ln is None else 8 * x.shape[1])
                     + x.numel() * (1 if a else 4 if f32 else 2) + (4 * x.shape[0] if a else 0)
                     for x, ln, a in runs)
        ops = sum(x.numel() * (8 if ln is not None else 1) + (x.numel() * 3 if a else 0)
                  for x, ln, a in runs)
        # library: F.layer_norm on the same f32 rows where every prologue is
        # a LayerNorm (it leaves out the rounding to bf16); null for W8A8,
        # whose per-row int8 codes and scales no PyTorch call makes
        lib_ms = None if act_quant else device_ms(lambda: [
            Fn.layer_norm(x, (x.shape[1],), ln[0], ln[1], 1e-5) for x, ln, _ in runs])
        entry("gemm_small_m_prep", site, err, ms, pms, nbytes, ops, lib_ms,
              f"{len(runs)} launches: the prologues of one step, M={M},"
              f" {'W8A8 codes and scales' if act_quant else 'f32 rows' if f32 else 'bf16 rows'}"
              f"{'; max_abs_err in codes' if act_quant else ''}", in_line, F32_OPS_PER_S)

    def check_attention(site, q, k, v, bounds, reps_layers, in_line=True, **gk):
        check_masked_attention(entry, site, q, k, v, bounds, reps_layers, in_line, **gk)

    def check_sample(site, rows, greedy):
        check_sample_epilogue(entry, g, dev, vocab, VP, site, rows, greedy)

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
        NAR_XL_B, NAR_AL_B = [20, 52, 150, 256], [832, 892, 1158, 2046]
        check_flash_nar(dev, entry, g, "flash_attention", [150], [1058], S_NAR, T_NAR)
        # the f32 NAR (compute_dtype="float32") on the CUDA-core forward: row g32
        check_flash_nar(dev, entry, g, "flash_attention", [150], [1058], S_NAR, T_NAR,
                        dtype=torch.float32)
        # the verify pass at decode_steps = 16: 16 queries per head
        check_attention("decode_verify", decode_q(1, 16), cache_k[0][None], cache_v[0][None],
                        one, NL, in_line=False)
        # 40 queries: three query groups of the kernel's grid, the last ragged
        check_attention("decode_verify", decode_q(1, 40), cache_k[0][None], cache_v[0][None],
                        one, NL, in_line=False)
        check_prep("decode_verify", packed, 8, False)
        # the floor of every device_ms row, on a line of its own
        say("empty launch ms " + json.dumps({k: round(v, 4) for k, v in empty_launch_ms(dev).items()}))
        check_sample("decode_block_fused", 1, False)
        check_sample("decode_verify", 8, True)
        check_sample_rejects(dev)

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
        check_flash_nar(dev, entry, g, "flash_attention_batched", NAR_XL_B, NAR_AL_B, S_NAR,
                        T_NAR)
        check_gemm("decode_block_fused_batched", packed, 4, "one batched step")
        check_gemm("decode_block_fused_batched", packed, 8, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", draft, 4, "one batched step", in_line=False)
        check_gemm("decode_block_fused_batched", draft, 8, "one batched step", in_line=False)
        check_sample("decode_block_fused_batched", 8, False)

    # ---- phase 3c: best_of, filtered sampling, more rows, f32 ----------------
    with phase("3c kernels vs plain, best_of / filtered / f32", 300):
        # the edge rows draw from a generator of their own: the later phases'
        # random inputs stay as they were before those rows
        boundary_total = filtered_rows(entry, g, dev, vocab, VP,
                                       torch.Generator(device=dev).manual_seed(16))
        say(f"  filtered epilogue: {boundary_total} kept-set difference(s) at the nucleus"
            f" boundary over the {len(FILTERED_ROWS)} checks")
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
        # more f32 rows: each row bitwise its M = 1 product (gemm_ffma_kernel)
        check_gemm("decode_block_fused_batched", packed32, 4, "one f32 batched step",
                   in_line=False)
        check_gemm("decode_block_fused_batched", packed32, 20, "one f32 batched step",
                   in_line=False)
        # the f32 LayerNorm rows of the prep kernel (row dp32)
        check_prep("decode_verify", packed32, 8, False, in_line=False, dtype=torch.float32)
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
        train_kernel_checks(dev, entry, g)
        check_layout_rule(dev)

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
        # the NAR attention at hd 128, as phases 3 and 3b (rows g128, k128)
        check_flash_nar(dev, entry, g, "flash_attention" + HD128, [150], [1058], S_NAR, T_NAR,
                        H=H8, hd=HD8)
        check_flash_nar(dev, entry, g, "flash_attention_batched" + HD128, NAR_XL_B, NAR_AL_B,
                        S_NAR, T_NAR, H=H8, hd=HD8)
        # the training attention at hd 128, as phase 3e
        train_kernel_checks(dev, entry, g, H=H8, hd=HD8, suffix=HD128)
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
        # the NAR at C >= 1536 through the flash forward: one request with the
        # 758-frame fuxuan prompt (as phase 6), then a batch of two
        for label, run_nar in (
                ("generate_audio", lambda: [api.generate_audio(
                    "The quick brown fox jumps over the lazy dog.", prompt="fuxuan",
                    language="en", max_duration=4.0, seed=1)]),
                ("generate_audio_batch", lambda: api.generate_audio_batch(
                    ["The quick brown fox jumps over the lazy dog.", "Hello world."],
                    ["fuxuan", "paimon"], language="en", top_k=1))):
            before = sum(n for (kn, st), n in loader.launch_counts.items()
                         if kn == "flash_attention_fwd" and st in ("flash_attention",
                                                                   "flash_attention_batched"))
            waves = run_nar()
            nar = sum(n for (kn, st), n in loader.launch_counts.items()
                      if kn == "flash_attention_fwd" and st in ("flash_attention",
                                                                "flash_attention_batched")) - before
            if not (nar > 0 and all(len(w) > 0 and np.isfinite(w).all() for w in waves)):
                fail(f"3f {label} at hd 128, NAR >= 1536: {nar} flash launches, waves"
                     f" {[len(w) for w in waves]}")
            say(f"  hd 128: {label}, NAR >= 1536: {[len(w) // 320 for w in waves]} frames,"
                f" {nar} NAR flash launches, NAR {b128.last.seconds['nar']:.2f} s")
        counts_hd128 = dict(loader.launch_counts)
        # the NAR at the offline cells' shape at hd 128, as phase 3g
        nar_cell_check(dev, b128.model)
        api._bundle = bundle
        del b128, packed8, draft8
        torch.cuda.empty_cache()

    # ---- phase 3g: the NAR at the offline cells' shape (flash at C = 1280) ------
    with phase("3g NAR at the cells' shape", 180):
        nar_cell_check(dev, bundle.model, entry)

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

    # ---- the later phases' model (LATER_LAYERS layers a stack) --------------
    full = bundle
    later_cfg = dataclasses.replace(cfg, num_layers=LATER_LAYERS)
    # the trees preload_models(random_weights=True, seed=0) draws, drawn once
    later_trees = dict(params=init_vallex(later_cfg, torch.Generator().manual_seed(0)),
                       vocos_params=init_vocos(torch.Generator().manual_seed(1)),
                       encodec_params=init_encodec(torch.Generator().manual_seed(2)))

    def later(ecfg=None, device=dev):
        """A bundle of the later phases' weights under `ecfg`, as api's."""
        return api.preload_models(device=device, cfg=later_cfg, ecfg=ecfg, **later_trees)

    bundle = later()

    # ---- phases 5b and 5c: the batched path ----------------------------------
    base_ecfg, base_pipe = bundle.ecfg, bundle.pipeline

    def use(**changes):
        """Serve with another EngineConfig on the same model and weights."""
        e = dataclasses.replace(base_ecfg, **changes)
        p = SynthesisPipeline(bundle.model, later_cfg, e, bundle.vocos)
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
    cli_dir = tempfile.mkdtemp(prefix="vallex-cli-")
    with phase("5d best_of / filtered / long text / f32", 600):
        cli_wav = os.path.join(cli_dir, "cli.wav")
        cli = Beside([sys.executable, "-m", "vallex_tpu_torch.cli", "synthesize", "Hi.",
                      "--random-weights", "--top-k", "1", "-o", cli_wav])
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

        rc, err, secs = cli.wait(300)
        if rc != 0 or not os.path.exists(cli_wav):
            fail(f"5d CLI: rc {rc}: {err[-1500:]}")
        with wave_mod.open(cli_wav) as f:
            n = f.getnframes()
        say(f"  python -m vallex_tpu_torch.cli synthesize: rc 0, {n / 24000:.2f} s WAV in"
            f" {secs:.2f} s (a process of its own, beside the phase's work since its start)")

        # compute_dtype="float32" through the f32 kernels, against the plain
        # path on the CPU (the per-token loop, which never speculates): once
        # with K-step blocks at M = 1, once with the default speculation (an
        # int8 draft over the f32 cache, f32 verify passes of 8 positions)
        req = dict(text="Hello world.", prompt="paimon", language="en", top_k=1,
                   max_duration=0.86)  # a cap of 64 frames
        gpu32 = {}
        for spec in ("off", "auto"):
            e32 = dataclasses.replace(base_ecfg, compute_dtype="float32", speculative=spec)
            later(e32)
            before = loader.launch_counts.get(("gemm_small_m", "decode_verify"), 0)
            t0 = time.perf_counter()
            api.generate_audio(**req)
            gpu32[spec] = (api._bundle.last, time.perf_counter() - t0,
                           loader.launch_counts.get(("gemm_small_m", "decode_verify"), 0) - before)
        if gpu32["auto"][2] == 0 or gpu32["off"][2] != 0:
            fail(f"5d f32: verify products launched {gpu32['off'][2]} times without speculation"
                 f" and {gpu32['auto'][2]} times with it")
        later(e32, "cpu")
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
        later(e16)
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
        cli_wav = os.path.join(cli_dir, "cli-w8a8.wav")
        cli = Beside([sys.executable, "-m", "vallex_tpu_torch.cli", "synthesize", "Hi.",
                      "--random-weights", "--top-k", "1", "--quantize", "w8a8", "-o", cli_wav])
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
            later(e32)
            t0 = time.perf_counter()
            api.generate_audio(**req)
            gpu32[name] = (api._bundle.last, time.perf_counter() - t0)
        # cpu32: 5d's CPU plain path on the same request (the per-token loop)
        for name, (res, t_gpu) in gpu32.items():
            if not (len(res.codes) == 64 and np.array_equal(res.codes, cpu32.codes)):
                fail(f"5e f32, {name}: codes {res.codes.shape} on the card vs"
                     f" {cpu32.codes.shape} on the CPU")
            say(f"  f32 greedy request (64 frames), {name}: codes on the card equal the CPU"
                f" plain path's, all 8 codebooks; {t_gpu:.2f} s on the card,"
                f" {res.ar.iterations} steps")
        api._bundle = bundle
        use()
        rc, err, secs = cli.wait(300)
        if rc != 0 or not os.path.exists(cli_wav):
            fail(f"5e CLI --quantize w8a8: rc {rc}: {err[-1500:]}")
        with wave_mod.open(cli_wav) as f:
            n = f.getnframes()
        say(f"  python -m vallex_tpu_torch.cli synthesize --quantize w8a8: rc 0,"
            f" {n / 24000:.2f} s WAV in {secs:.2f} s (beside the phase's work since its start)")
    shutil.rmtree(cli_dir, ignore_errors=True)
    counts_slice4 = dict(loader.launch_counts)

    # ---- phase 5f: training --------------------------------------------------
    loader.reset_launch_counts()
    with phase("5f training", 300):
        train_path(dev, cfg)
    counts_slice5 = dict(loader.launch_counts)

    # ---- phase 5g: checkpoint files, continual, make_prompt, Whisper ---------
    loader.reset_launch_counts()
    with phase("5g checkpoints / continual / make_prompt / whisper", 270):
        prompt_paths(dev, api, bundle, smi.splitlines()[0])
    counts_slice6 = dict(loader.launch_counts)

    # ---- phase 5h: long text overlapped on two streams, VALL-F, Transformer TTS
    loader.reset_launch_counts()
    with phase("5h long-text overlap / VALL-F / Transformer TTS", 150):
        api._bundle = bundle
        long_text_overlap(api, bundle, smi.splitlines()[0])
        model_zoo(dev, smi.splitlines()[0])
    counts_slice7 = dict(loader.launch_counts)
    if not counts_slice7.get(("flash_attention_fwd", "flash_attention"), 0):
        fail("5h: no flash forward launched at the NAR's site")

    # ---- phase 5i: the gradio UI, multi-GPU serving, dp x tp training ---------
    loader.reset_launch_counts()
    with phase("5i UI / multi-GPU serving / dp x tp training", 150):
        api._bundle = bundle
        multi_paths(dev, api, bundle, full.model, smi.splitlines()[0])
    counts_slice8 = dict(loader.launch_counts)

    # ---- phase 5j: the native host runtime (no kernel: host code and EnCodec)
    loader.reset_launch_counts()
    with phase("5j native host runtime", 60):
        native_host_paths(dev, api, bundle, smi.splitlines()[0])
    counts_slice9 = dict(loader.launch_counts)

    # ---- phase 5k: the hybrid AR (kernels/ssm_step.cu, ops/decode_hybrid.py) --
    loader.reset_launch_counts()
    with phase("5k hybrid AR", 240):
        counts_slice10 = hybrid_paths(dev, entries, smi.splitlines()[0])

    with phase("8 kernels line", 30):
        for site, counts in (("flash_attention", counts_single),
                             ("flash_attention_batched", counts_batched)):
            if counts.get(("masked_attention", site), 0):
                fail(f"masked_attention launched at the NAR's site {site}")
        for e in entries:
            kernel, site = e["name"].split("@")
            if site == HYBRID_SITE:  # phase 5k counted its own
                if e["launches"] == 0:
                    fail(f"{e['name']}: no launch on the hybrid AR's path")
                continue
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
        say(f"  phase 5g launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice6.items())})}")
        say(f"  phase 5h launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice7.items())})}")
        say(f"  phase 5i launches by site (this process; the workers' and ranks' are above): {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice8.items())})}")
        say(f"  phase 5j launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice9.items())})}")
        say(f"  phase 5k launches by site: {json.dumps({f'{k}@{s}': n for (k, s), n in sorted(counts_slice10.items())})}")
        say(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "unit"} for e in entries]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
