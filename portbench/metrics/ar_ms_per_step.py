"""The pipeline's AR seconds (prefill and decode) per decode step run
(blocks × K), over the untraced batches, in ms."""


def read(run):
    recs = run.untraced()
    steps = sum(r.steps for r in recs)
    return 1e3 * sum(r.seconds.get("ar", 0.0) for r in recs) / steps if steps else None
