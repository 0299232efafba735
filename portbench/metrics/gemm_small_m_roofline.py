"""The traced batch's decode products (gemm_small_m: its prep and product
kernels): the least time their bytes and operations need at the device's
peaks (the architecture's `gemm_small_m_bound_s`), over those kernels' own
device time (harness/trace.py), in %."""

KERNELS = r"\bgemm_(tc|prep|ffma)_kernel\b"
WEIGHT_BYTES = {"none": None, "int8": 1, "w8a8": 1, "int8kv": 1}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    rec, t = run.traced(), run.trace
    bound_s = getattr(run.arch, "gemm_small_m_bound_s", None)
    if rec is None or t is None or bound_s is None:
        return None
    busy = t.seconds_matching(KERNELS)
    if not busy:
        return None
    e = run.engine
    wb = WEIGHT_BYTES[e.get("quantize", "none")] or DTYPE_BYTES[e.get("compute_dtype",
                                                                      "bfloat16")]
    bound = bound_s(run.model, wb, [g for _, _, g in rec.requests], rec.steps)
    return 100.0 * bound / busy
