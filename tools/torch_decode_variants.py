"""Variants of the decode attention kernel (vallex_tpu_torch/kernels/
masked_attention.cu) or of the sampling epilogue (sample_epilogue.cu) on one
GPU: each variant is the source with one design choice changed, built alone
(nvcc, a library of its own) and timed on PERF.md's rows of that kernel
through chip_smoke.py's checks.

    python3 tools/torch_decode_variants.py [--kernel attention|sample]
                                           [--variants a,b] [--rows b,e,i]

Sampling variants: `row_warps1`, `row_warps2`, `row_warps8` (warps a row in
the unfiltered kernel; 4 ships), `warps1` (one filtered row a block, not 4),
`match_any` (the radix histogram's atomics aggregated by __match_any_sync),
`no_early` (all 4 radix passes, no exit at an exact bin), `no_sort` (top-p
always by the register bisection, never the sorted candidates), `no_list`
(the draw over the whole row, not the compacted kept set), `full_range` (the
bisection over the whole int32 range, as the old kernel ran it); rows c, f,
j, v, l, l20, l-p, l-k, l200 (chip_smoke.py's SAMPLE_ROWS). Attention variants: `cluster16` (16 blocks a cluster, the non-portable size),
`ring2` (two slots a warp), `no_pdl` (no programmatic dependent launch),
`warps8` (up to 8 warps a block), `unrolled` (the chunk and P.V loops
unrolled as at one query), `walk_off` (no key walked: the launch, the
bounds, the merge and the barrier alone; its checks fail and are printed,
not fatal). The build prints each variant's ptxas line per instance
(registers, spills); then the rows run for `base`, each variant, `base`
again, one JSON `variant` line each: the site, ms, SDPA's ms and the error
against the plain version. Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = os.path.join(HERE, "vallex_tpu_torch", "kernels")


def _sub(old: str, new: str):
    def apply(src: str) -> str:
        if old not in src:
            raise SystemExit(f"variant: {old[:60]!r} is not in the source")
        return src.replace(old, new, 1)
    return apply


SAMPLE_VARIANTS = {
    "row_warps1": [_sub("#define SE_ROW_WARPS 4 ", "#define SE_ROW_WARPS 1 ")],
    "row_warps2": [_sub("#define SE_ROW_WARPS 4 ", "#define SE_ROW_WARPS 2 ")],
    "row_warps8": [_sub("#define SE_ROW_WARPS 4 ", "#define SE_ROW_WARPS 8 ")],
    "warps1": [_sub("#define SE_WARPS 4 ", "#define SE_WARPS 1 ")],
    "match_any": [_sub("  atomicAdd(&hist[on ? bin : 256u + lane], 1u);",
                       "  const unsigned peers = __match_any_sync(VX_FULL_MASK, on ? bin : 256u + lane);\n"
                       "  if (__ffs(peers) - 1 == lane) atomicAdd(&hist[on ? bin : 256u + lane],"
                       " (unsigned)__popc(peers));")],
    "no_early": [_sub("if (in_bin == krem && shift > 0) {", "if (false) {")],
    "no_sort": [_sub("if (n <= SE_CAP) {", "if (false) {")],
    "no_list": [_sub("if (listed >= 1 && listed <= SE_LIST) {", "if (false) {")],
    "full_range": [_sub("int lo = kmin, hi = kmax;", "int lo = INT_MIN, hi = INT_MAX;")],
}

VARIANTS = {
    "cluster16": [
        _sub("#define ATT_CLUSTER 8 ", "#define ATT_CLUSTER 16 "),
        _sub("  err = cudaFuncSetAttribute(masked_attention_split_kernel<TKV, HD, QMAX>,\n",
             "  err = cudaFuncSetAttribute(masked_attention_split_kernel<TKV, HD, QMAX>,"
             " cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
             "  if (err != cudaSuccess) return err;\n"
             "  err = cudaFuncSetAttribute(masked_attention_split_kernel<TKV, HD, QMAX>,\n")],
    "ring2": [_sub("#define ATT_RING 1 ", "#define ATT_RING 2 ")],
    "no_pdl": [_sub("    cfg.attrs = attr;\n    cfg.numAttrs = 2;", "    cfg.attrs = attr;\n    cfg.numAttrs = 1;")],
    "warps8": [_sub("return 81920 / (ATT_RING * att_slot<TKV, HD>()) >= 4   ? 4",
                    "return 81920 / (ATT_RING * att_slot<TKV, HD>()) >= 8 ? 8"
                    " : 81920 / (ATT_RING * att_slot<TKV, HD>()) >= 4 ? 4")],
    "unrolled": [_sub("constexpr int C_UNROLL = QMAX >= 8 ? 1 : CPR;", "constexpr int C_UNROLL = CPR;"),
                 _sub("constexpr int PV_UNROLL = QMAX >= 8 ? 2 : 4;", "constexpr int PV_UNROLL = 4;")],
    "walk_off": [_sub("const int mine = first < t_end ? (t_end - first + NW - 1) / NW : 0;",
                      "const int mine = 0;")],
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="attention", choices=("attention", "sample"))
    ap.add_argument("--variants", default="")
    ap.add_argument("--rows", default="")
    args = ap.parse_args()
    sample = args.kernel == "sample"
    variants = SAMPLE_VARIANTS if sample else VARIANTS
    src = os.path.join(KERNELS, "sample_epilogue.cu" if sample else "masked_attention.cu")
    args.variants = args.variants or ",".join(variants)
    args.rows = args.rows or ("c,f,j,v,l,l20,l-p,l-k,l200" if sample else "b,b128,e,e16,e128,i,m,n,p,q")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("FAIL no CUDA device: this benchmark runs on the GPU", file=sys.stderr)
        sys.exit(1)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vallex_tpu_torch.kernels import loader

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    cs.say(f"card: {smi.splitlines()[0] if smi else 'nvidia-smi gave nothing'}")
    names = ["base"] + [v for v in args.variants.split(",") if v]
    src0 = open(src).read()
    loader.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="decode_variants_", dir=loader.BUILD_DIR)
    procs = {}
    for name in names:
        text = src0
        for fn in variants.get(name, []):
            text = fn(text)
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [loader._nvcc(), *loader.NVCC_FLAGS, "-shared", "-I", str(loader.SRC_DIR), cu,
             "-o", os.path.join(work, f"lib_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            cs.fail(f"variant {name}: nvcc failed\n{out[-3000:]}")
        for blk in out.split("Compiling entry function")[1:]:
            inst = re.search(r"\dmasked_attention_split_kernelI(13__nv_bfloat16|f|a)Li(\d+)ELi(\d+)E",
                             blk.split("\n")[0])
            said = [ln.split(":", 1)[-1].strip() for ln in blk.splitlines()[1:]
                    if "spill" in ln or "Used" in ln]
            nc = re.search(r"\d(sample_epilogue_\w+_kernel)ILi(\d+)E", blk.split("\n")[0])
            if inst:
                cs.say(f"  ptxas {name} <{cs.ATT_KV[inst.group(1)]}, {inst.group(2)},"
                       f" {inst.group(3)}>: {'; '.join(said)}")
            elif nc:
                cs.say(f"  ptxas {name} {nc.group(1)}<{nc.group(2)}>: {'; '.join(said)}")
    cs.fail = lambda msg: cs.say(f"  check (not fatal here): {msg[:120]}")
    dev = torch.device("cuda")
    rows = tuple(args.rows.split(","))
    for name in names + ["base"]:
        lib = ctypes.CDLL(os.path.join(work, f"lib_{name}.so"))
        for fn, argtypes in loader._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        loader._lib = lib

        def entry(kernel, site, err, ms, plain_ms, bytes_, ops, library_ms, unit, in_line=True,
                  ops_per_s=0.0, name=name):
            cs.say("variant " + json.dumps(dict(
                variant=name, site=site, ms=round(ms, 4),
                library_ms=None if library_ms is None else round(library_ms, 4),
                max_abs_err=float(err), unit=unit)))

        g = torch.Generator(device=dev).manual_seed(1)
        if sample:
            cs.sample_rows(entry, g, dev, 1025, 1152, rows)
        else:
            cs.decode_attention_rows(entry, g, dev, rows)
    shutil.rmtree(work, ignore_errors=True)
    cs.say("variants ok")


if __name__ == "__main__":
    main()
