"""The pipeline's NAR seconds over the wall time of the untraced batches, in %."""


def read(run):
    recs = [r for r in run.untraced() if "nar" in r.seconds]
    wall = sum(r.wall for r in recs)
    return 100.0 * sum(r.seconds["nar"] for r in recs) / wall if wall > 0 else None
