"""Device events (kernels, copies and memsets) of the traced batch's AR
decode loop, per decode step of that batch (blocks × K).

The loop is the program's `vallex.ar.decode` span: it opens after a host
read that waits for the prefill and holds one host read a block, each a
device-to-host copy, the last of them the loop's last device event. The
device's clock and the host's are aligned only to within a fraction of a
millisecond, so the events are not cut at the span's host times: they run
from the event after the prefill's copy to the last block's copy, in device
order, where the first block's copy is the one nearest the first
`vallex.ar.read` span."""

SPAN, READ, COPY = "vallex.ar.decode", "vallex.ar.read", "Memcpy DtoH"


def read(run):
    rec, t = run.traced(), run.trace
    if rec is None or t is None or not rec.steps:
        return None
    spans = [(a, b) for a, b, name in t.spans if name == SPAN]
    if len(spans) != 1:
        return None
    lo, hi = spans[0]
    reads = sorted(a for a, _, name in t.spans if name == READ and lo <= a < hi)
    events = sorted(t.kernels)
    copies = [i for i, (_, _, name) in enumerate(events) if name.startswith(COPY)]
    if not reads or not copies:
        return None
    j = min(range(len(copies)), key=lambda c: abs(events[copies[c]][0] - reads[0]))
    if j == 0 or j + len(reads) > len(copies):
        return None
    return (copies[j + len(reads) - 1] - copies[j - 1]) / rec.steps
