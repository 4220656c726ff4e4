"""hidden_sum_roofline.eval: K1 (csrc/hidden_sum.cu) in the traced
scoring batches: the sum of its least times (perfbench/work.py:
hidden_sum_ms, from each batch's valid slots and partner hits) over the
sum of its measured times, in percent."""

from perfbench import work


def read(r):
    if r.kind != "rank" or r.config["aggregator"] != "mean":
        return None
    measured = r.trace.seconds_of("hidden_sum_fwd_kernel")
    if not measured:
        return None
    ncol, h = int(r.config["num_steps"]), int(r.config["hidden_dim"])
    least = sum(work.hidden_sum_ms(o, hh, q, ncol, h, False)
                for o, hh, q in r.unit_counts)
    return 100.0 * least / (measured * 1e3)
