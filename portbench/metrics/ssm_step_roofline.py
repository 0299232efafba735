"""The traced batch's Mamba-2 step updates (ssm_step_kernel): the least
time their bytes need at the device's peak bandwidth (the architecture's
`ssm_step_bound_s`: every row the block runs × Mamba layers × steps × the
f32 state read and written, x, B, C, dt and z read and y written), over
those kernels' own device time (harness/trace.py), in %."""

KERNELS = r"\bssm_step\w*_kernel\b"


def read(run):
    rec, t = run.traced(), run.trace
    bound_s = getattr(run.arch, "ssm_step_bound_s", None)
    if rec is None or t is None or bound_s is None:
        return None
    busy = t.seconds_matching(KERNELS)
    if not busy:
        return None
    return 100.0 * bound_s(run.model, len(rec.requests), rec.steps) / busy
