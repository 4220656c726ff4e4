"""The mean Net's bf16 route gradients at several initial weights: each
bf16 route's distance to the fp32 plain route's gradient (all-one
labels), beside the fused - plain distance chip_smoke holds.

Run from the repository root on one GPU (it imports chip_smoke.py and
builds the kernels):

    python3 results/torch_h100/init_grad_probe.py > results/torch_h100/init_grad_probe.log
"""
import math
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
trainer, tedges, tlabels, _ = cs.train_setup(spgk, "mean")
be = tedges[:, :cs.BATCH]
ones = torch.ones(cs.BATCH, device=cs.DEVICE)


def old_init(seed):
    """The weights the port drew before: untruncated N(0, 2/(in+out))
    from a CPU generator, Linear by Linear in children order."""
    gen = torch.Generator().manual_seed(seed)
    m = cs.make_net("mean", dropout=0.1, dtype="bfloat16")
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.Linear):
                fo, fi = mod.weight.shape
                mod.weight.copy_(torch.empty(fo, fi).normal_(
                    0.0, math.sqrt(2.0 / (fi + fo)), generator=gen))
                mod.bias.zero_()
    return m


variants = {f"key {s}": cs.make_net("mean", dropout=0.1, dtype="bfloat16",
                                    key=prng.prng_key(s)) for s in range(4)}
variants.update({f"old generator {s}": old_init(s) for s in range(2)})
for name, m in variants.items():
    fused = cs.route_grads(spgk, m, be, "bfloat16", True, labels=ones)
    plain = cs.route_grads(spgk, m, be, "bfloat16", False, labels=ones)
    ref = cs.route_grads(spgk, m, be, "float32", False, labels=ones)
    f32f = cs.route_grads(spgk, m, be, "float32", True, labels=ones)
    worst = lambda a, b: max(cs.rel_err(a[1][k], b[1][k]) for k in b[1])
    per = {k: (float(f"{cs.rel_err(fused[1][k], plain[1][k]):.2e}"),
               float(f"{cs.rel_err(fused[1][k], ref[1][k]):.2e}"),
               float(f"{cs.rel_err(plain[1][k], ref[1][k]):.2e}"))
           for k in ref[1]}
    cs.say(f"{name}: loss bf16 fused {fused[0]:.6f} plain {plain[0]:.6f} "
           f"fp32 {ref[0]:.6f}; worst fused-plain {worst(fused, plain):.3e}, "
           f"fused-fp32 {worst(fused, ref):.3e}, plain-fp32 "
           f"{worst(plain, ref):.3e}, fp32 fused-plain {worst(f32f, ref):.3e}")
    cs.say(f"  by tensor (fused-plain, fused-fp32, plain-fp32): {per}")
