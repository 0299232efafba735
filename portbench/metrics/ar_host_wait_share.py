"""The host's wait for the device inside the batched AR's decode loop (the
program's `seconds["ar_wait"]`: host clock inside each block's host read)
over the loop (`seconds["ar_decode"]`), over the untraced batches, in %:
near 0 the host paces the loop, near 100 the device does."""


def read(run):
    recs = [r for r in run.untraced() if "ar_wait" in r.seconds and "ar_decode" in r.seconds]
    loop = sum(r.seconds["ar_decode"] for r in recs)
    return 100.0 * sum(r.seconds["ar_wait"] for r in recs) / loop if loop > 0 else None
