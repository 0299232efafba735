"""The batched AR's decode loop (the program's `seconds["ar_decode"]`: host
clock from the first block's enqueue to the last block's host read, which
leaves the device done) per decode step run (blocks × K), over the untraced
batches, in ms: `ar_ms_per_step` without the prefill."""


def read(run):
    recs = [r for r in run.untraced() if "ar_decode" in r.seconds]
    steps = sum(r.steps for r in recs)
    return 1e3 * sum(r.seconds["ar_decode"] for r in recs) / steps if steps else None
