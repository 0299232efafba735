"""Generated audio seconds of the window's whole batches over their wall time."""


def read(run):
    recs = run.untraced()
    wall = sum(r.wall for r in recs)
    return sum(r.audio_s for r in recs) / wall if wall > 0 else None
