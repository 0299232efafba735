"""The hybrid AR's prefill scans (the program's `seconds["ar_scan"]`: CUDA
events around each Mamba layer's chunked scan) over the wall time of the
untraced batches, in %; None for a program or model without them."""


def read(run):
    recs = [r for r in run.untraced() if "ar_scan" in r.seconds]
    wall = sum(r.wall for r in recs)
    return 100.0 * sum(r.seconds["ar_scan"] for r in recs) / wall if wall > 0 else None
