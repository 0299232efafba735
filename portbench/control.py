"""Readings that set a cell's limits: the program's and the control's, on
many seeds, at the cell's own size, in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--out FILE]

For each seed: the cell's weights and program, the window's first batch
(greedy, at the cell's batch size and lengths), then the check's sample of
its requests through the float32 reference and through the control (the
reference in the lower precision the configuration names under `control`).
One JSON line a seed: the program's numbers (each limit's lower reading is
their largest) and the control's (the upper reading is their smallest).
Needs a CUDA device; `--device cpu` runs it at whatever size the cell says.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=ROOT, help="checkout holding BENCHMARK.json")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import check as C
    from portbench.harness.runner import draw_trees, run_batch, setup
    from portbench.harness.spec import load_cell
    from portbench.harness.traffic import Traffic
    from portbench.reference.vocos import Vocos

    cell = load_cell(args.workload, args.root)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        bundle = setup(cell, seed, dev)
        K = max(2, bundle.ecfg.decode_steps)
        b = Traffic(cell.traffic, seed, cell.root, stream=0).next_batch()
        res, rec = run_batch(bundle.pipeline, b, K)
        items, failed = C.items_of(b, res.outputs, bundle.ecfg.audio_buckets)
        bundle = res = None
        from vallex_tpu_torch import api

        api._bundle = None
        gc.collect()
        picked = C.sample(items, seed, n_sampled=0)
        tree, vtree = draw_trees(cell, seed, dev)
        out = C.readings(cell.arch.reference(tree, cell.config["model"]), Vocos(vtree), picked,
                         control=cell.config["control"])
        row = {"workload": cell.name, "seed": seed, "greedy": b.greedy, "failed": failed,
               "checked": len(picked), "frames": sum(len(i.codes) for i in picked),
               "batch_s": rec.wall, "seconds": time.perf_counter() - t0, **out}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        tree = vtree = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for k in rows[0]["program"]:
        lo = max(r["program"][k] for r in rows)
        up = min(r["control"][k] for r in rows)
        print(f"{k}: program max {lo!r}, control min {up!r}, ratio {up / lo if lo else float('inf'):.3g}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
