"""attn_pool_roofline.train: K3 and K3 bwd (csrc/attn_pool.cu,
csrc/attn_pool_bwd.cu and its reduction) in the traced training steps:
the sum of their least times (perfbench/work.py: attn_pool_ms, from each
step's valid slots and partner hits) over the sum of their measured
times, in percent."""

from perfbench import work

KERNELS = ("attn_pool_fwd_kernel", "attn_pool_bwd_kernel",
           "attn_pool_bwd_reduce")


def read(r):
    if r.kind != "train" or r.config["aggregator"] != "attn":
        return None
    measured = r.trace.seconds_of(*KERNELS)
    if not measured:
        return None
    ncol, h = int(r.config["num_steps"]), int(r.config["hidden_dim"])
    least = sum(work.attn_pool_ms(o, hh, q, ncol, h, False)
                + work.attn_pool_ms(o, hh, q, ncol, h, True)
                for o, hh, q in r.unit_counts)
    return 100.0 * least / (measured * 1e3)
