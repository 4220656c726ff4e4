"""optimizer_ms_per_step.train: device milliseconds of the operations
issued under the program's span `surel.optimizer` (the global-norm clip
and Adam's step), per training step."""

SPAN = "surel.optimizer"


def read(r):
    s = r.trace.span_s.get(SPAN)
    if r.kind != "train" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
