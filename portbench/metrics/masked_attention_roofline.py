"""The traced batch's decode attention (masked_attention): the least time
each live row's valid K and V need at the device's peak bandwidth, over
the device time of its kernels, in %."""

from portbench.roofline.counts import masked_attention_bound_s

KERNELS = r"\bmasked_attention\w*_kernel\b"
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    rec, t = run.traced(), run.trace
    if rec is None or t is None:
        return None
    busy = t.seconds_matching(KERNELS)
    if not busy:
        return None
    e = run.engine
    kv = 1 if e.get("quantize") == "int8kv" else DTYPE_BYTES[e.get("compute_dtype",
                                                                     "bfloat16")]
    return 100.0 * masked_attention_bound_s(run.model, kv, rec.requests, rec.steps) / busy
