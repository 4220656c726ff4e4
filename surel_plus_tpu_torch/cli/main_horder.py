"""Higher-order pattern prediction (port of
surel_plus_tpu/cli/main_horder.py, the reference's main_horder.py:24-141):
3-node hyperedge (triplet) queries over one encoder graph, HONet, MRR
against k random third nodes a triplet.

Loads a triplet dataset and draws its training negatives
(`DEHyperDataset.process`), builds a set for every node of the encoder
graph, then per run trains between evaluations (MRR), stops early on the
validation MRR (`ResultLogger`) and logs each run's statistics. The epoch
blocks are the JAX CLI's: epoch 0 alone, then `eval_steps` epochs a block
(the last one shorter), an evaluation after each block. The engines, by
`--engine` (auto: device on the card, host on the CPU, as the JAX CLI
picks by its backend): device, packed-key sets, `DeviceTrainer.fit` over
the hyperedge keys join (`make_keys_hjoin`) and `evaluate_device`; host,
encoding-table sets (`subg_matrix`), `LinkPredictor` over
`hgather_join` (its epochs ordered by the seed's numpy Generator) and
`evaluate`.

Usage:
  python -m surel_plus_tpu_torch.cli.main_horder \\
      --dataset npz:surel_plus_tpu/data/fixtures/tags_fixture.npz \\
      --num_walks 50 --num_steps 3 --k 10 --epochs 12 ...

It runs on the CUDA device. `SUREL_PLATFORM=cpu` runs it on the CPU, the
kernels' plain versions in their place; without that variable and with no
CUDA device it raises.

Datasets: `synth*` a random one, `npz:<file>` an export, else the
reference's torch pickle `./dataset/sgrl/<dataset>.pl`. At an early stop
the CLI writes the checkpoint `{log_dir}/{dataset}/model/{stamp}_{run}`
(the HONet's parameters and the epoch, `utils/checkpoint.py`), as the
JAX CLI does; `--inf_only --load_model PATH` loads the parameters,
evaluates once and returns {'results': ...}.

`--resume` is ignored, as the JAX package's higher-order CLI ignores it
(it has no mid-training resume). The draws are the JAX CLI's: the sets
from `--seed`'s key tree, run r's epochs from `prng_key(seed + 1000 +
r)`, split once an evaluation block, run r's weights from
`prng_key(seed + r)` (flax's `init` of the JAX HONet).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict

import numpy as np
import torch

from surel_plus_tpu_torch.cli.main import device_engine, platform_device
from surel_plus_tpu_torch.graph.datasets import (
    DEHyperDataset,
    synthetic_hyper_data,
)
from surel_plus_tpu_torch.graph.splits import get_pos_neg_edges
from surel_plus_tpu_torch.models import HONet
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import hgather_join, make_keys_hjoin
from surel_plus_tpu_torch.ops.sampler import (
    subg_matrix,
    subg_matrix_device_keys,
)
from surel_plus_tpu_torch.train import LinkPredictor, TrainConfig, evaluate
from surel_plus_tpu_torch.train.device import (
    evaluate_device,
    trainer_from_keys,
)
from surel_plus_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from surel_plus_tpu_torch.utils.config import (
    ExperimentConfig,
    add_config_args,
    config_from_args,
)
from surel_plus_tpu_torch.utils.logger import ResultLogger, set_up_log
from surel_plus_tpu_torch.utils.profiling import metrics
from surel_plus_tpu_torch.utils.seeding import set_random_seed


def check_options(cfg: ExperimentConfig) -> None:
    """Raise ValueError for an engine the CLI has not."""
    if cfg.engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {cfg.engine!r}")


def load_hyper(cfg: ExperimentConfig) -> DEHyperDataset:
    if "synth" in cfg.dataset:
        return synthetic_hyper_data(num_nodes=cfg.synth_nodes,
                                    num_triplets=cfg.synth_edges,
                                    seed=cfg.seed)
    if cfg.dataset.startswith("npz:"):
        return DEHyperDataset.from_npz(cfg.dataset[4:], k=cfg.k)
    # tags-math / DBLP-coauthor pickles (dataloader.py:243), read by the
    # same torch.load call as the JAX package's
    data = torch.load(f"./dataset/sgrl/{cfg.dataset}.pl")
    return DEHyperDataset(np.asarray(data["edge_index"]),
                          {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                           for k, v in data["triplets"].items()},
                          k=cfg.k)


def run_experiment(cfg: ExperimentConfig, logger=None,
                   device="cuda") -> Dict:
    """Returns {'best': [(valid, test) per run], 'results': ResultLogger,
    'trainer': the DeviceTrainer or LinkPredictor, its HONet as the last
    run left it, 'edges': the training hyperedges [3, E] (on the device
    for the device engine, on the host for the host engine)}; with
    --inf_only --load_model, {'results': the evaluation}. The phase timer
    is reset first, so its report covers this call."""
    check_options(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: set SUREL_PLATFORM=cpu (or "
                           "pass device='cpu') to run on the CPU")
    metrics.reset()
    rng = set_random_seed(cfg.seed)
    if logger is None:
        logger = set_up_log(cfg.log_dir, cfg.dataset,
                            args_repr=str(dataclasses.asdict(cfg)))
    cfg.metric = "MRR"  # always MRR (the reference's main_horder.py:69)

    with metrics.phase("load"):
        ds = load_hyper(cfg)
        G_enc = ds.process(logger)

    prep_start = time.time()
    fused = {"auto": None, "on": True, "off": False}[cfg.fused_hidden]
    # undrawn: each run's `trainer.init` draws the weights
    model = HONet(input_dim=cfg.num_steps, hidden_dim=cfg.hidden_channels,
                  dropout=cfg.dropout, fused_hidden=fused, key=None,
                  device=device)
    tcfg = TrainConfig(batch_size=cfg.batch_size, lr=cfg.lr,
                       epochs=cfg.epochs, eval_steps=cfg.eval_steps,
                       early_stop=cfg.early_stop, seed=cfg.seed)
    seeds = np.arange(G_enc.num_nodes, dtype=np.int32)
    use_device_engine = device_engine(cfg.engine, device)
    if use_device_engine:
        spgk = subg_matrix_device_keys(
            G_enc, seeds, num_walks=cfg.num_walks, num_steps=cfg.num_steps,
            seed=cfg.seed, device=device)
        trainer = trainer_from_keys(model, spgk, tcfg, join_factory=(
            functools.partial(make_keys_hjoin,
                              **model.join_outputs(device))))
    else:
        spg = subg_matrix(G_enc, seeds, num_walks=cfg.num_walks,
                          num_steps=cfg.num_steps, seed=cfg.seed,
                          device=device)
        trainer = LinkPredictor(model, spg, tcfg, join_fn=hgather_join,
                                device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger.info("Prep. Runtime (LP): %.2fs", time.time() - prep_start)
    metrics.add("prep", time.time() - prep_start)

    pos = ds.pos_hedge.T.astype(np.int32)
    neg = ds.neg_hedge.T.astype(np.int32)
    edges = np.concatenate([pos, neg], axis=1)
    labels = np.concatenate([np.ones(pos.shape[1], np.float32),
                             np.zeros(neg.shape[1], np.float32)])
    val_edge = get_pos_neg_edges("valid", ds.split_edge, None,
                                 ds.num_nodes, percent=cfg.valid_perc)
    test_edge = get_pos_neg_edges("test", ds.split_edge, None,
                                  ds.num_nodes)
    inf_edge = {"valid": val_edge, "test": test_edge}
    if use_device_engine:
        edges_dev = torch.as_tensor(edges, dtype=torch.int64).to(device)
        labels_dev = torch.as_tensor(labels).to(device)
        inf_dev = {split: tuple(torch.as_tensor(e, dtype=torch.int64).to(
            device) for e in pair) for split, pair in inf_edge.items()}

        def run_epochs(n, key):
            return trainer.fit(edges_dev, labels_dev, n, key)

        def run_eval():
            return evaluate_device(trainer, inf_dev, "MRR")
    else:
        edges_dev = edges

        def run_epochs(n, key):
            losses, aucs = zip(*(trainer.train_epoch(edges, labels, rng, sub)
                                 for sub in prng.split(key, n)))
            return torch.tensor(losses), torch.tensor(aucs)

        def run_eval():
            return evaluate(trainer, inf_edge, "MRR")

    if cfg.inf_only and cfg.load_model:
        # the reference's main_horder.py:134-137
        model.load_state_dict(load_checkpoint(cfg.load_model)["params"])
        results, d_inf = run_eval()
        logger.info("inference-only results: %s (T_test %.2fs)",
                    results, d_inf)
        return {"results": results}

    rlog = ResultLogger(runs=cfg.runs, metric="MRR",
                        early_stop=cfg.early_stop)
    stamp = time.strftime("%m%d%y_%H%M%S")
    for run in range(cfg.runs):
        trainer.init(prng.prng_key(cfg.seed + run))
        key = prng.prng_key(cfg.seed + 1000 + run)
        epoch = 0
        while epoch < cfg.epochs:
            # epoch 0 alone, then blocks of eval_steps epochs, an
            # evaluation after each block
            n = 1 if epoch == 0 else min(cfg.eval_steps,
                                         cfg.epochs - epoch)
            key, sub = prng.split(key)
            with metrics.phase("train_epoch", items=edges.shape[1] * n):
                losses, aucs = (x.cpu().numpy() for x in run_epochs(n, sub))
            for i in range(n):
                logger.info("Run: %02d, Epoch: %02d, Loss: %.4f, "
                            "AUC: %.4f", run + 1, epoch + i,
                            float(losses[i]), float(aucs[i]))
            epoch += n
            with metrics.phase("eval"):
                results, d_inf = run_eval()
            logger.info("eval MRR: %s (T_test %.2f)", results, d_inf)
            if rlog.add_result(run, results):
                # the checkpoint at the stop (main_horder.py:107)
                save_checkpoint(
                    {"params": model.state_dict(), "epoch": epoch - 1},
                    f"{cfg.log_dir}/{cfg.dataset}/model/{stamp}_{run}")
                break
        rlog.print_statistics(run=run, logger=logger)
    metrics.log_report(logger)
    return {"results": rlog,
            "best": [rlog.best(r) for r in range(cfg.runs)],
            "trainer": trainer, "edges": edges_dev}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SUREL+ on PyTorch/CUDA: higher-order pattern "
                    "prediction")
    add_config_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    out = run_experiment(cfg, device=platform_device())
    print(out.get("best"))


if __name__ == "__main__":
    main()
