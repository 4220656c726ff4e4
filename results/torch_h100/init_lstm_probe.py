"""The lstm Net's fp32 route gradients at key 0 (random labels, one bench
batch): fused and plain on the card and on the CPU (plain versions),
pairwise, with each tensor's largest gradient.

Run from the repository root on one GPU (it imports chip_smoke.py and
builds the kernels):

    python3 results/torch_h100/init_lstm_probe.py > results/torch_h100/init_lstm_probe.log
"""
import math
import sys
import time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels import build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all(sorted({k["kernel"].source for k in cs.KERNELS.values()}))
cs.say(cs.card_label())
g = cs.rmat_graph(cs.N_NODES, cs.N_EDGES, seed=0)
spgk, net, edges = cs.serve_path(g, cs.card_label())
_, tedges, tlabels, _ = cs.train_setup(spgk, "lstm")
be = tedges[:, :cs.BATCH]
lab = tlabels[:cs.BATCH]


def old_init(seed):
    gen = torch.Generator().manual_seed(seed)
    m = cs.make_net("lstm", dropout=0.1, dtype="bfloat16")
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 2:
                fo, fi = p.shape
                p.copy_(torch.empty(fo, fi).normal_(
                    0.0, math.sqrt(2.0 / (fi + fo)), generator=gen))
            else:
                p.zero_()
    return m


def cpu_grads(m, fused):
    """The route on the CPU: the model, sets and batch copied there."""
    dev = cs.DEVICE
    cs.DEVICE = "cpu"
    try:
        sets = cs.SpGKeys(nodes=spgk.nodes.cpu(), khi=spgk.khi.cpu(),
                          klo=spgk.klo.cpu(), sizes=spgk.sizes.cpu(),
                          num_walks=spgk.num_walks,
                          num_steps=spgk.num_steps)
        mc = cs.make_net("lstm", dropout=0.1, dtype="bfloat16",
                         device="cpu")
        mc.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        out = cs.route_grads(sets, mc, be.cpu(), "float32", fused,
                             labels=lab.cpu())
    finally:
        cs.DEVICE = dev
    return out[0], {k: v.to(dev) for k, v in out[1].items()}


torch.set_num_threads(8)
for name, m in (("key 0", cs.make_net("lstm", dropout=0.1,
                                      dtype="bfloat16",
                                      key=prng.prng_key(0))),
                ("old generator 0", old_init(0))):
    t0 = time.time()
    r = {"card fused": cs.route_grads(spgk, m, be, "float32", True,
                                      labels=lab),
         "card plain": cs.route_grads(spgk, m, be, "float32", False,
                                      labels=lab)}
    r["cpu fused"] = cpu_grads(m, True)
    r["cpu plain"] = cpu_grads(m, False)
    cs.say(f"{name} ({time.time() - t0:.1f} s): losses "
           f"{ {k: round(v[0], 7) for k, v in r.items()} }")
    top = {k: float(f"{float(v.abs().max()):.3e}")
           for k, v in r["card plain"][1].items()}
    cs.say(f"  largest |gradient| (card plain): {top}")
    names = list(r)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = r[names[i]][1], r[names[j]][1]
            rel = {k: float(f"{cs.rel_err(a[k], b[k]):.2e}") for k in b}
            cs.say(f"  {names[i]} vs {names[j]}: worst "
                   f"{max(rel.values()):.3e} {rel}")
