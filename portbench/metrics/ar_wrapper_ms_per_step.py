"""Host time inside the hand-written kernels' Python wrappers during the
batched AR's decode loop (the program's `seconds["ar_wrappers"]`, from its
`kernels/loader.py::launch_seconds`) per decode step run (blocks × K), over
the untraced batches, in ms."""


def read(run):
    recs = [r for r in run.untraced() if "ar_wrappers" in r.seconds]
    steps = sum(r.steps for r in recs)
    return 1e3 * sum(r.seconds["ar_wrappers"] for r in recs) / steps if steps else None
