"""launches_per_batch.eval: device kernels the profiler saw in the traced
window, per scored batch."""


def read(r):
    if r.kind != "rank" or not r.traced_units or not r.trace.kernels():
        return None
    return len(r.trace.kernels()) / r.traced_units
