"""How much a fixture row's accuracy moves with the draw of its sets.

Every run of a CLI row trains over the same sets: the packed-key sets are
sampled once, from `--seed`, before the first run, so the spread over a
row's runs leaves out the draw of the sets. This script measures that
draw's share. On the CPU, it loads a fixture row's data as the CLI does,
samples the observed and the inference graph's sets with the port's
sampler or the JAX package's, from each of seeds 0 .. S-1, trains the
port's trainer over them for a few epochs (the row's model, bfloat16,
`--runs` initializations and batch orders a seed) and prints the row's
metric on the test split. Run from the repository root, on the CPU:

    python results/torch_h100/sampler_seeds.py --dataset fixture-collabs \\
        --aggrs mean --num_walks 50 --k 10 --seeds 6 --runs 2 --epochs 1

Like the tests, it imports both packages (the JAX one only for its
sampler, forced onto the CPU).
"""

import argparse
import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from surel_plus_tpu.graph.csr import CSRGraph as JaxCSRGraph  # noqa: E402
from surel_plus_tpu.ops import sampler as jax_sampler  # noqa: E402
from surel_plus_tpu_torch.cli.main import load_link_data  # noqa: E402
from surel_plus_tpu_torch.models import Net  # noqa: E402
from surel_plus_tpu_torch.ops.prng import prng_key  # noqa: E402
from surel_plus_tpu_torch.ops.sampler import (  # noqa: E402
    subg_matrix_device_keys,
)
from surel_plus_tpu_torch.spg import SpGKeys  # noqa: E402
from surel_plus_tpu_torch.train import TrainConfig  # noqa: E402
from surel_plus_tpu_torch.train.device import (  # noqa: E402
    evaluate_device,
    trainer_from_keys,
)
from surel_plus_tpu_torch.utils.config import (  # noqa: E402
    ExperimentConfig,
    apply_dataset_overrides,
)
from surel_plus_tpu_torch.utils.seeding import set_random_seed  # noqa: E402


def keys(graph, sampler, cfg, seed):
    seeds = np.arange(graph.num_nodes, dtype=np.int32)
    if sampler == "port":
        return subg_matrix_device_keys(graph, seeds, cfg.num_walks,
                                       cfg.num_steps, seed=seed,
                                       device="cpu")
    k = jax_sampler.subg_matrix_device_keys(
        JaxCSRGraph(indptr=graph.indptr, indices=graph.indices,
                    data=graph.data), seeds, num_walks=cfg.num_walks,
        num_steps=cfg.num_steps, seed=seed)
    t = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    return SpGKeys(t(k.nodes), t(k.khi), t(k.klo), t(k.sizes), k.num_walks,
                   k.num_steps)


def test_metric(scorer, inf_edge, metric):
    """The test split's value of the row's metric (`evaluate_device`)."""
    results, _ = evaluate_device(scorer, inf_edge, metric)
    return (results[metric] if "Hits" in metric else results)[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fixture-collabs")
    ap.add_argument("--aggrs", default="mean")
    ap.add_argument("--num_walks", type=int, default=50)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--samplers", default="port,jax")
    args = ap.parse_args()
    cfg = apply_dataset_overrides(ExperimentConfig(
        dataset=args.dataset, aggrs=args.aggrs, num_walks=args.num_walks,
        num_steps=3, k=args.k, batch_size=args.batch_size))
    data = load_link_data(cfg, set_random_seed(cfg.seed),
                          logging.getLogger(__name__))
    edges = np.concatenate(data.train_edge, axis=1)
    labels = np.concatenate([
        np.ones(data.train_edge[0].shape[1], np.float32),
        np.zeros(data.train_edge[1].shape[1], np.float32)])
    inf_edge = {split: tuple(torch.as_tensor(e, dtype=torch.int64)
                             for e in pair)
                for split, pair in data.inf_edge.items()}
    tcfg = TrainConfig(batch_size=cfg.batch_size)
    for sampler in args.samplers.split(","):
        per_seed = []
        for seed in range(args.seeds):
            xk = keys(data.graphs["train"], sampler, cfg, seed)
            zk = keys(data.graphs["test"], sampler, cfg, seed)
            res = []
            for run in range(args.runs):
                net = Net(cfg.num_steps, cfg.hidden_channels,
                          dropout=cfg.dropout, aggrs=cfg.aggrs,
                          dtype="bfloat16", key=None, device="cpu")
                trainer = trainer_from_keys(net, xk, tcfg)
                scorer = trainer_from_keys(net, zk, tcfg)
                trainer.init(prng_key(run))
                trainer.fit(edges, labels, args.epochs,
                            prng_key(1000 + run))
                res.append(100 * test_metric(scorer, inf_edge,
                                             cfg.metric))
            per_seed.append(np.mean(res))
            print(f"{args.dataset} {args.aggrs} {sampler} sampler, seed "
                  f"{seed}: test {cfg.metric} x100 after {args.epochs} "
                  f"epoch(s) {[f'{x:.2f}' for x in res]}", flush=True)
        print(f"{args.dataset} {args.aggrs} {sampler} sampler over seeds "
              f"0-{args.seeds - 1}: {np.mean(per_seed):.2f}"
              f"±{np.std(per_seed):.2f} {[f'{x:.2f}' for x in per_seed]}",
              flush=True)


if __name__ == "__main__":
    main()
