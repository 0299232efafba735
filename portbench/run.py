"""Benchmark of vallex_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the check's numbers beside their
limits on standard error, then one JSON line on standard output with
`correct`, `attempted`, `failed`, `metrics`, `device` (and, traced,
`breakdown`) and, last, `checks`. Exits non-zero with no result when no
CUDA device (or fewer than the cell asks for) is present, or when JAX or
the JAX package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".portbench_cache")  # build and kernel caches, fixed paths


def _env() -> None:
    """Every build and kernel cache inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["USE_FLAX"] = "0"
    # one host thread for CPU operators: the AR loop is host-paced, and idle
    # worker threads spinning beside it make its step time vary
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_line(out, cell, trace: bool) -> dict:
    run = out["run"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = run.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness.runner import run_cell
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        say(f"needs {need} CUDA device(s), found {n}: no result")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, log=say)
    if out["banned"]:
        say(f"imported {', '.join(out['banned'])} (JAX or the JAX package): no result")
        return 3
    line = result_line(out, cell, bool(args.trace))
    say(f"checked {out['checked']} requests of {out['attempted']}; {out['failed']} malformed")
    for name, c in line["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
