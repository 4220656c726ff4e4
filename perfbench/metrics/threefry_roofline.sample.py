"""threefry_roofline.sample: K8 (csrc/threefry.cu) in the traced sampling
passes: its least time for the words the passes draw (perfbench/work.py:
threefry_ms) over its measured time, in percent."""

from perfbench import work


def read(r):
    if r.kind != "sample" or not r.words:
        return None
    measured = r.trace.seconds_of("threefry_bits_kernel")
    if not measured:
        return None
    return 100.0 * work.threefry_ms(r.words) / (measured * 1e3)
