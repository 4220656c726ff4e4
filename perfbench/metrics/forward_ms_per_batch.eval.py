"""forward_ms_per_batch.eval: device milliseconds of the operations
issued under the program's span `surel.forward` (the model and its
sigmoid), per scored batch."""

SPAN = "surel.forward"


def read(r):
    s = r.trace.span_s.get(SPAN)
    if r.kind != "rank" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
