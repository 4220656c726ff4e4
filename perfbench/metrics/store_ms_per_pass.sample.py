"""store_ms_per_pass.sample: device milliseconds of the operations
issued under the program's span `surel.sample.store` (the concatenation
of the blocks' sets), per sampling pass."""

SPAN = "surel.sample.store"


def read(r):
    s = r.trace.span_s.get(SPAN)
    if r.kind != "sample" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
