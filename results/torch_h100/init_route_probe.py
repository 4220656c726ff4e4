"""Key 0: each aggregator's bf16 routes against each other and against
the fp32 plain route (all-one labels; a random cotangent on the scorer's
input), and the share of the scorer's relu decisions the routes part.

Run from the repository root on one GPU (it imports chip_smoke.py and
builds the kernels):

    python3 results/torch_h100/init_route_probe.py > results/torch_h100/init_route_probe.log
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
cot = torch.randn(cs.BATCH, 2 * cs.HIDDEN,
                  generator=torch.Generator().manual_seed(5)).to(cs.DEVICE)


def scorer_pre(m, dtype, fused):
    """The scorer's first-layer pre-activations [B, H] on one route."""
    c = cs.make_net(m.aggrs, dropout=0.1, dtype=dtype, fused_hidden=fused)
    c.load_state_dict(m.state_dict())
    tr = cs.trainer_for(c, spgk, cs.TrainConfig(batch_size=cs.BATCH),
                        join_factory=None if fused else cs.pair_join)
    joined, _ = tr._batch(be)
    seen = []
    h = c.affinity_score.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.cat(args[0], dim=-1)))
    with torch.no_grad():
        c.eval()(joined)
        h.remove()
        fc0 = c.affinity_score.fc0
        return torch.nn.functional.linear(
            seen[0].to(c.dtype), fc0.weight.to(c.dtype),
            fc0.bias.to(c.dtype)).float()


for aggrs in ("mean", "attn", "lstm"):
    m = cs.make_net(aggrs, dropout=0.1, dtype="bfloat16",
                    key=prng.prng_key(0))
    for what, kw in (("all-one labels", dict(labels=ones)),
                     ("random cotangent", dict(cot=cot))):
        fused = cs.route_grads(spgk, m, be, "bfloat16", True, **kw)
        plain = cs.route_grads(spgk, m, be, "bfloat16", False, **kw)
        ref = cs.route_grads(spgk, m, be, "float32", False, **kw)
        keys = [k for k in ref[1] if k != cs.GATE_BIAS]
        worst = lambda a, b: max(cs.rel_err(a[1][k], b[1][k]) for k in keys)
        cs.say(f"{aggrs} {what}: worst fused-plain {worst(fused, plain):.3e}"
               f", fused-fp32 {worst(fused, ref):.3e}, plain-fp32 "
               f"{worst(plain, ref):.3e}")
    pf, pp, p32 = (scorer_pre(m, "bfloat16", True),
                   scorer_pre(m, "bfloat16", False),
                   scorer_pre(m, "float32", False))
    flips = lambda a, b: float(((a > 0) != (b > 0)).float().mean())
    unit = ((pf > 0) != (pp > 0)).float().mean(0)
    cs.say(f"{aggrs} scorer relu decisions parted: fused-plain "
           f"{flips(pf, pp):.4%}, fused-fp32 {flips(pf, p32):.4%}, "
           f"plain-fp32 {flips(pp, p32):.4%}; most in one unit "
           f"{float(unit.max()):.2%}; that unit's pre-activation mean "
           f"{float(p32[:, unit.argmax()].mean()):.3e}, std "
           f"{float(p32[:, unit.argmax()].std()):.3e}")
