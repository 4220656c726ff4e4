"""device_idle_pct.sample: the share of the traced window in which no
operation ran on the device (one less the union of the device
operations' intervals over the window's wall time), in percent."""


def read(r):
    if r.kind != "sample" or r.trace.window_s <= 0 or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
