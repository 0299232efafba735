"""The model's operations for the untraced batches' requests (AR prefill
and decode over live rows, the NAR's stages over valid positions and
pairs, Vocos; the architecture's `request_flops`) over their wall time ×
the bf16 dense peak, in %."""

from portbench.roofline.counts import PEAKS


def read(run):
    request_flops = getattr(run.arch, "request_flops", None)
    recs = run.untraced()
    wall = sum(r.wall for r in recs)
    if request_flops is None or wall <= 0:
        return None
    m, v = run.model, run.cell.config["vocos"]
    flops = sum(request_flops(m, v, q) for r in recs for q in r.requests)
    return 100.0 * flops / (wall * PEAKS["bf16_flops_per_s"])
