"""join_ms_per_step.train: device milliseconds of the operations issued
under the benchmark's span around the trainer's join, per training
step."""

from perfbench.trace import JOIN_SPAN


def read(r):
    s = r.trace.span_s.get(JOIN_SPAN)
    if r.kind != "train" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
