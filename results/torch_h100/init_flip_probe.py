"""The lstm Net at key 0, fp32, random labels: the scorer's relu decisions
the fused and plain routes part, their pre-activations, and the route
gradients with those queries' weights 0.

Run from the repository root on one GPU (it imports chip_smoke.py and
builds the kernels):

    python3 results/torch_h100/init_flip_probe.py > results/torch_h100/init_flip_probe.log
"""
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels import build
from surel_plus_tpu_torch.train.device import batch_loss

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all(sorted({k["kernel"].source for k in cs.KERNELS.values()}))
g = cs.rmat_graph(cs.N_NODES, cs.N_EDGES, seed=0)
spgk, net, edges = cs.serve_path(g, cs.card_label())
_, tedges, tlabels, _ = cs.train_setup(spgk, "lstm")
be = tedges[:, :cs.BATCH]
lab = tlabels[:cs.BATCH]
m = cs.make_net("lstm", dropout=0.1, dtype="bfloat16", key=prng.prng_key(0))


def run(fused, weights):
    c = cs.make_net("lstm", dropout=0.1, dtype="float32", fused_hidden=fused)
    c.load_state_dict(m.state_dict())
    tr = cs.trainer_for(c, spgk, cs.TrainConfig(batch_size=cs.BATCH),
                        join_factory=None if fused else cs.pair_join)
    joined, _ = tr._batch(be)
    seen = []
    h = c.affinity_score.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.cat(args[0], dim=-1)))
    logits = c.train()(joined, key=prng.prng_key(3))
    h.remove()
    fc0 = c.affinity_score.fc0
    pre = torch.nn.functional.linear(seen[0], fc0.weight, fc0.bias).detach()
    loss = batch_loss(logits, lab, weights)
    loss.backward()
    return pre, {k: p.grad for k, p in c.named_parameters()}


ones = torch.ones(cs.BATCH, device=cs.DEVICE)
pf, gf = run(True, ones)
pp, gp = run(False, ones)
part = (pf > 0) != (pp > 0)
q = part.any(dim=1)
cs.say(f"parted decisions {int(part.sum())} in {int(q.sum())} queries; "
       f"their |pre| (plain) {pp[part].abs().tolist()}, fused "
       f"{pf[part].tolist()}, plain {pp[part].tolist()}; max |pre| "
       f"{float(pp.abs().max()):.3e}; min |pre| over all "
       f"{float(pp.abs().min()):.3e}")
diff = (pf - pp).abs()
cs.say(f"pre-activation |fused - plain| max {float(diff.max()):.3e}, "
       f"relative to max |pre| {float(diff.max() / pp.abs().max()):.3e}")
rel = lambda a, b: {k: float(f"{cs.rel_err(a[k], b[k]):.2e}") for k in b}
cs.say(f"all queries: {rel(gf, gp)}")
w = (~q).float()
_, gf2 = run(True, w)
_, gp2 = run(False, w)
cs.say(f"without the parted queries: {rel(gf2, gp2)}")
