"""sets_ms_per_pass.sample: device milliseconds of the operations issued
under the program's span `surel.sample.sets` (the blocks' dedup sort,
prefix sums, compaction and packing), per sampling pass."""

SPAN = "surel.sample.sets"


def read(r):
    s = r.trace.span_s.get(SPAN)
    if r.kind != "sample" or not s or not r.traced_units:
        return None
    return 1e3 * s / r.traced_units
