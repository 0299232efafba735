"""The traced batch's decode attention (masked_attention): the least time
each live row's valid K and V need at the device's peak bandwidth (the
architecture's `masked_attention_bound_s`), over its kernels' own device
time (harness/trace.py), in %."""

KERNELS = r"\bmasked_attention\w*_kernel\b"
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    rec, t = run.traced(), run.trace
    bound_s = getattr(run.arch, "masked_attention_bound_s", None)
    if rec is None or t is None or bound_s is None:
        return None
    busy = t.seconds_matching(KERNELS)
    if not busy:
        return None
    e = run.engine
    kv = 1 if e.get("quantize") == "int8kv" else DTYPE_BYTES[e.get("compute_dtype",
                                                                     "bfloat16")]
    return 100.0 * bound_s(run.model, kv, rec.requests, rec.steps) / busy
