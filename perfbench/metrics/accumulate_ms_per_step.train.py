"""accumulate_ms_per_step.train: device milliseconds of the operations
issued under the program's span `surel.accumulate` (the step's AUC
histograms and loss sums), per training step."""

SPAN = "surel.accumulate"


def read(r):
    s = r.trace.span_s.get(SPAN)
    if r.kind != "train" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
