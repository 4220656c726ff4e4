"""forward_ms_per_step.train: device milliseconds of the operations
issued under the program's span `surel.forward` (the model and its
loss), per training step."""

SPAN = "surel.forward"


def read(r):
    s = r.trace.span_s.get(SPAN)
    if r.kind != "train" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
