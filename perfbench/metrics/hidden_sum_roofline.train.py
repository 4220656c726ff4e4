"""hidden_sum_roofline.train: K1 and K1 bwd (csrc/hidden_sum.cu,
csrc/hidden_sum_bwd.cu and its partial-sum reduction) in the traced
training steps: the sum of their least times (perfbench/work.py:
hidden_sum_ms, from each step's valid slots and partner hits) over the
sum of their measured times, in percent."""

from perfbench import work

KERNELS = ("hidden_sum_fwd_kernel", "hidden_sum_bwd_kernel",
           "reduce_partials")


def read(r):
    if r.kind != "train" or r.config["aggregator"] != "mean":
        return None
    measured = r.trace.seconds_of(*KERNELS)
    if not measured:
        return None
    ncol, h = int(r.config["num_steps"]), int(r.config["hidden_dim"])
    least = sum(work.hidden_sum_ms(o, hh, q, ncol, h, False)
                + work.hidden_sum_ms(o, hh, q, ncol, h, True)
                for o, hh, q in r.unit_counts)
    return 100.0 * least / (measured * 1e3)
