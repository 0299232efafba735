"""The batched AR's prefill (the program's `seconds["ar_prefill"]`: CUDA
events around the prefill forward, the int8 K/V quantization and the first
token) over the wall time of the untraced batches, in %."""


def read(run):
    recs = [r for r in run.untraced() if "ar_prefill" in r.seconds]
    wall = sum(r.wall for r in recs)
    return 100.0 * sum(r.seconds["ar_prefill"] for r in recs) / wall if wall > 0 else None
