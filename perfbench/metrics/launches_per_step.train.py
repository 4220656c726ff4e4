"""launches_per_step.train: device kernels the profiler saw in the traced
window, per training step."""


def read(r):
    if r.kind != "train" or not r.traced_units or not r.trace.kernels():
        return None
    return len(r.trace.kernels()) / r.traced_units
