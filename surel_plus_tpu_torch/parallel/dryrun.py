"""Multi-device dry run: every distributed path once at tiny shapes, in
each rank (the sequence of the JAX package's `dryrun_multichip`,
__graft_entry__.py:68-224).

    python -m surel_plus_tpu_torch.parallel.dryrun --ranks 4 --device cpu
    python -m surel_plus_tpu_torch.parallel.dryrun --ranks 4 --device cuda \
        --backend gloo

In each rank, over the default (data, graph) mesh: the table step
(`DistributedTrainStep` over a host SpG), the keys step
(`DistributedKeysTrainStep`), the scorer and `evaluate_distributed` for
Hits@50 and MRR, partitioned sampling (`partition_csr`,
`sample_gsets_partitioned`) feeding the keys step, the fused mean step,
and the HONet step and its scorer's MRR. Every loss and metric must be
finite; the ranks' results are returned in rank order.
"""

from __future__ import annotations

import argparse
import math
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.models import HONet, Net
from surel_plus_tpu_torch.ops.join import join_gathered_hkeys
from surel_plus_tpu_torch.ops.prng import prng_key
from surel_plus_tpu_torch.ops.sampler import (
    sample_gsets_device_keys,
    subg_matrix,
)
from surel_plus_tpu_torch.parallel.dist import (
    DistributedKeysHTrainStep,
    DistributedKeysScorer,
    DistributedKeysTrainStep,
    DistributedTrainStep,
    evaluate_distributed,
    shard_spg,
    shard_spg_keys,
)
from surel_plus_tpu_torch.parallel.launch import RankContext, run_ranks
from surel_plus_tpu_torch.parallel.mesh import make_mesh
from surel_plus_tpu_torch.parallel.partition import (
    partition_csr,
    sample_gsets_partitioned,
)

N_NODES, N_EDGES, NUM_WALKS, NUM_STEPS, HIDDEN = 256, 1024, 8, 3, 96
LR, GRAD_CLIP = 1e-3, 1.0
N_POS, K_NEG = 16, 4


def _fresh(cls, dev, **kw):
    """A model with the dry run's weights (flax's init from prng_key(0),
    as the JAX package's dry run draws them; the same on every rank) and
    its Adam."""
    model = cls(key=prng_key(0), device=dev, **kw)
    return model, torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)


def _finite(name: str, x: float) -> float:
    if not math.isfinite(x):
        raise RuntimeError(f"dry run: {name} is not finite ({x})")
    return x


def dryrun_rank(ctx: RankContext) -> Dict[str, float]:
    """The dry run in one rank; returns its losses and metrics."""
    dev = ctx.device
    mesh = make_mesh(device=dev)
    n_dev = ctx.world_size
    g = rmat_graph(N_NODES, N_EDGES, seed=0)
    seeds = np.arange(N_NODES, dtype=np.int32)
    rng = np.random.default_rng(0)
    B = 8 * max(n_dev, 1)
    edges = rng.integers(0, N_NODES, size=(2, B)).astype(np.int32)
    labels = (np.arange(B) % 2).astype(np.float32)
    weights = np.ones(B, np.float32)
    out = {}

    # the table step over a host SpG (walks of NUM_STEPS - 1 steps)
    spg = subg_matrix(g, seeds, num_walks=NUM_WALKS, num_steps=NUM_STEPS,
                      block_size=N_NODES, device=dev)
    model, opt = _fresh(Net, dev, input_dim=NUM_STEPS, hidden_dim=HIDDEN,
                        aggrs="mean")
    step = DistributedTrainStep(model, opt, mesh, shard_spg(spg, mesh),
                                grad_clip=GRAD_CLIP)
    out["loss"] = _finite("table loss", float(step(edges, labels, weights, prng_key(1))))

    # the production layout: a row-sharded packed-key store
    layout = (NUM_WALKS, 2)
    spgk = sample_gsets_device_keys(g, seeds, NUM_WALKS, 2, seed=0,
                                    block_size=N_NODES, device=dev)
    sspgk = shard_spg_keys(spgk, mesh)
    kw = dict(input_dim=3, hidden_dim=HIDDEN, aggrs="mean",
              key_layout=layout)
    model_k, opt_k = _fresh(Net, dev, **kw)
    kstep = DistributedKeysTrainStep(model_k, opt_k, mesh, sspgk,
                                     grad_clip=GRAD_CLIP)
    out["keys_loss"] = _finite("keys loss",
                               float(kstep(edges, labels, weights,
                                     prng_key(2))))

    # sharded scoring and its metrics
    scorer = DistributedKeysScorer(model_k, mesh, sspgk, batch_size=B)
    scores = scorer(edges)
    if not bool(torch.isfinite(scores).all()):
        raise RuntimeError("dry run: a score is not finite")
    rng_e = np.random.default_rng(7)
    pos_e = rng_e.integers(0, N_NODES, size=(2, N_POS)).astype(np.int32)
    neg_e = rng_e.integers(0, N_NODES,
                           size=(2, N_POS * K_NEG)).astype(np.int32)
    inf_edge = {"valid": (pos_e, neg_e), "test": (pos_e, neg_e)}
    hits, _ = evaluate_distributed(scorer, inf_edge, "Hits@50")
    out["eval_hits50"] = _finite("Hits@50", hits["Hits@50"][2])
    mrr, _ = evaluate_distributed(scorer, inf_edge, "MRR")
    out["eval_mrr"] = _finite("MRR", mrr[2])

    # graphs beyond one device: the partitioned sampler feeds the step
    pcsr = partition_csr(g, n_dev, seed=0)
    spgk_p = sample_gsets_partitioned(pcsr, seeds, NUM_WALKS, 2, mesh,
                                      seed=0)
    model_p, opt_p = _fresh(Net, dev, **kw)
    pstep = DistributedKeysTrainStep(model_p, opt_p, mesh,
                                     shard_spg_keys(spgk_p, mesh),
                                     grad_clip=GRAD_CLIP)
    out["partitioned_loss"] = _finite(
        "partitioned loss",
        float(pstep(edges, labels, weights, prng_key(3))))

    # the fused route (K1 and K1 bwd on the card, their plain versions on
    # the CPU) inside the sharded step
    model_f, opt_f = _fresh(Net, dev, fused_hidden=True, **kw)
    fstep = DistributedKeysTrainStep(model_f, opt_f, mesh, sspgk,
                                     grad_clip=GRAD_CLIP)
    out["fused_loss"] = _finite("fused loss",
                                float(fstep(edges, labels, weights,
                                     prng_key(4))))

    # hyperedges: 3-endpoint gathers -> join_gathered_hkeys -> HONet
    rng = np.random.default_rng(5)
    hedges = rng.integers(0, N_NODES, size=(3, B)).astype(np.int32)
    honet, opt_h = _fresh(HONet, dev, input_dim=3, hidden_dim=HIDDEN,
                          key_layout=layout)
    hstep = DistributedKeysHTrainStep(honet, opt_h, mesh, sspgk,
                                      grad_clip=GRAD_CLIP)
    out["hyperedge_loss"] = _finite("hyperedge loss",
                                    float(hstep(hedges, labels, weights,
                                          prng_key(6))))
    hscorer = DistributedKeysScorer(honet, mesh, sspgk, batch_size=B,
                                    join_gathered=join_gathered_hkeys)
    pos_h = rng.integers(0, N_NODES, size=(3, N_POS)).astype(np.int32)
    neg_h = rng.integers(0, N_NODES,
                         size=(3, N_POS * K_NEG)).astype(np.int32)
    hmrr, _ = evaluate_distributed(
        hscorer, {"valid": (pos_h, neg_h), "test": (pos_h, neg_h)}, "MRR")
    out["hyper_mrr"] = _finite("hyperedge MRR", hmrr[2])
    out["mesh"] = dict(mesh.shape)
    return out


def dryrun_multichip(n_ranks: int, backend: Optional[str] = None,
                     device="cuda", timeout_s: float = 600.0
                     ) -> List[Dict[str, float]]:
    """Run the dry run in `n_ranks` rank processes (`run_ranks`) and print
    its line; raises if a rank fails."""
    with tempfile.TemporaryDirectory() as payload:
        res = run_ranks("surel_plus_tpu_torch.parallel.dryrun:dryrun_rank",
                        n_ranks, backend, device, payload, timeout_s)
    r = res[0]
    print(f"dryrun_multichip({n_ranks}): mesh={r['mesh']} "
          f"loss={r['loss']:.4f} keys_loss={r['keys_loss']:.4f} "
          f"partitioned_loss={r['partitioned_loss']:.4f} "
          f"fused_loss={r['fused_loss']:.4f} "
          f"hyperedge_loss={r['hyperedge_loss']:.4f} "
          f"eval_hits50={r['eval_hits50']:.3f} eval_mrr={r['eval_mrr']:.3f} "
          f"hyper_mrr={r['hyper_mrr']:.3f} OK", flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="multi-device dry run")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    a = ap.parse_args()
    dryrun_multichip(a.ranks, a.backend, a.device)
