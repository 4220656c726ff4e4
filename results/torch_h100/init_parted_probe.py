"""Keys 0-3: each aggregator's route gradients as chip_smoke's
check_train_routes holds them (`held_route_grads`: fp32 with random
labels, bf16 with all-one labels, each less the queries whose scorer relu
decisions the two routes part), and beside them every query's bf16
distances to the fp32 plain gradient (fused, plain, and fused - plain).

Run from the repository root on one GPU (it imports chip_smoke.py and
builds the kernels):

    python3 results/torch_h100/init_parted_probe.py > results/torch_h100/init_parted_probe.log
"""
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels import build

build.build_all(sorted({k["kernel"].source for k in cs.KERNELS.values()}))
cs.say(cs.card_label())
g = cs.rmat_graph(cs.N_NODES, cs.N_EDGES, seed=0)
spgk, net, edges = cs.serve_path(g, cs.card_label())
_, tedges, tlabels, _ = cs.train_setup(spgk, "mean")
be = tedges[:, :cs.BATCH]
ones = torch.ones(cs.BATCH, device=cs.DEVICE)


def worst(a, b):
    """The largest share of a tensor's largest gradient that `a` and `b`
    differ by, the gate's bias left out."""
    return max(cs.rel_err(a[k], b[k]) for k in b if k != cs.GATE_BIAS)


failed = []
for s in range(4):
    for aggrs in ("mean", "attn", "lstm"):
        m = cs.make_net(aggrs, dropout=0.1, dtype="bfloat16",
                        key=prng.prng_key(s))
        cs.say(f"--- key {s}, {aggrs}")
        for dtype, labels, what in (
                ("float32", tlabels[:cs.BATCH], "random labels"),
                ("bfloat16", ones, "all-one labels")):
            try:
                cs.compare_grads(f"{dtype}, {what}", m, cs.held_route_grads(
                    spgk, m, be, dtype, labels), cs.GRAD_ROUTE_TOL[dtype])
            except cs.SmokeFailure as e:
                failed.append(f"key {s} {aggrs} {dtype}: {e}")
        fused, plain = (cs.route_grads(spgk, m, be, "bfloat16", f,
                                       labels=ones)[1] for f in (True, False))
        ref = cs.route_grads(spgk, m, be, "float32", False, labels=ones)[1]
        cs.say(f"key {s} {aggrs}, every query, bf16 all-one labels: worst "
               f"fused-fp32 {worst(fused, ref):.3e}, plain-fp32 "
               f"{worst(plain, ref):.3e}, fused-plain "
               f"{worst(fused, plain):.3e}")
cs.say(f"failed: {failed}")
