"""Experiment runner for link and relation prediction (port of
surel_plus_tpu/cli/main.py).

Loads a dataset (link data, or with 'mag' in its name a MAG relation:
`load_hetero`), masks a share of its train edges as training positives
and samples their negatives (`load_link_data`), builds a set for every
node of the observed graph (training) and of the inference graph
(scoring), then per run trains between evaluations, stops early on the
validation metric (`ResultLogger`) and logs the statistics over runs. The
trainer and the scorer wrap one `Net`, so the scorer reads the weights
the trainer just stepped; the scorer's optimizer is never stepped.

The sets, by `--sencoder`: LP, the landing-count sets of random walks;
PPR, SPD or DEG, the top-k PPR sets of the host push with their scalar
encoding (`_scalar_pipeline`; `--save_ppr` / `--load_ppr` keep the
inference graph's matrix in `{dataset}_z_{alpha}_{topk}_{eps}.npz`).
The engines, by `--engine` (auto: device on the card, host on the CPU,
as the JAX CLI picks by its backend): device, `DeviceTrainer.fit`
between `evaluate_device` calls, the Net in bfloat16, over packed-key
sets (LP) or ScalarSpG (the scalar encoders); `--balance_widths`
trains with `fit_balanced` over the given width classes, completed by
the bucket. host, `LinkPredictor` (a host loop that reads each step's
loss and predictions back) and `evaluate`, the Net in float32, over
encoding-table sets (LP, `subg_matrix`) or ScalarSpG
(`ScalarLinkPredictor`); `--balance_widths` is the device engine's
only.

Usage:
  python -m surel_plus_tpu_torch.cli.main --dataset fixture-collabs \\
      --aggrs mean --num_walks 50 --num_steps 3 --epochs 20 ...

It runs on the CUDA device. `SUREL_PLATFORM=cpu` runs it on the CPU, the
kernels' plain versions in their place; without that variable and with no
CUDA device it raises. `--engine auto` takes the host engine on the CPU,
as the JAX package's does on a CPU backend; `--engine device` runs the
device engine's code on CPU tensors.

Checkpoints (`utils/checkpoint.py`), at the JAX CLI's moments: before
each evaluation `{log_dir}/{dataset}/model/latest_{run}` (parameters,
optimizer state, epoch, the epoch key as JAX stores it (two uint32 words
under "key") and the numpy generator's state), and at an early stop
`{stamp}_{run}` (parameters and epoch). `--resume PATH` restores run 0
from a `latest` checkpoint and goes on at the epoch after it;
`--inf_only --load_model PATH` loads the parameters into the Net the
scorer shares, evaluates once and returns {'results': ...}.
`--use_pretrain` (with `--use_raw` and node features) appends
`pretrain_embedding.pt` of the working directory to the features.
`ogbl-*` datasets load through `from_ogb` (the `ogb` package, which
downloads them).

The draws are the JAX CLI's: the sets from `--seed`'s key tree
(`ops/sampler.py`), run r's epochs from `prng_key(seed + 1000 + r)`,
split once an evaluation block (`key, sub = split(key)`, sub the block's
`fit` key, or split again into one dropout key an epoch on the host
engine). Run r's weights are flax's `init(prng_key(seed + r))` of the
JAX Net (`trainer.init`), so one seed starts both CLIs from the same
weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.graph.datasets import (
    DEHDataset,
    LinkPropDataset,
    RawLinkData,
    fixture_link_data,
    from_ogb,
    npz_link_data,
    synthetic_hetero_data,
    synthetic_link_data,
)
from surel_plus_tpu_torch.graph.splits import get_pos_neg_edges
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.encoders import encoding, scalar_spg_from_csr
from surel_plus_tpu_torch.ops.ppr import topk_ppr_matrix
from surel_plus_tpu_torch.ops.sampler import (
    subg_matrix,
    subg_matrix_device_keys,
)
from surel_plus_tpu_torch.train import LinkPredictor, TrainConfig, evaluate
from surel_plus_tpu_torch.train.device import (
    evaluate_device,
    trainer_from_keys,
)
from surel_plus_tpu_torch.train.scalar import (
    ScalarLinkPredictor,
    scalar_trainer_from_spg,
)
from surel_plus_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from surel_plus_tpu_torch.utils.config import (
    ExperimentConfig,
    add_config_args,
    apply_dataset_overrides,
    config_from_args,
)
from surel_plus_tpu_torch.utils.logger import (
    ResultLogger,
    capture_stdout,
    set_up_log,
)
from surel_plus_tpu_torch.utils.profiling import metrics
from surel_plus_tpu_torch.utils.seeding import set_random_seed


class LinkData(NamedTuple):
    ds: Union[LinkPropDataset, DEHDataset]
    graphs: Dict[str, CSRGraph]     # "train" (observed), "val", "test"
    train_edge: Tuple[np.ndarray, np.ndarray]  # (pos, neg) int32 [2, E]
    inf_edge: Dict[str, Tuple[np.ndarray, np.ndarray]]  # valid, test


def check_options(cfg: ExperimentConfig) -> None:
    """Raise ValueError for an engine or set encoder the CLI has not."""
    if cfg.engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.sencoder not in ("LP", "PPR", "SPD", "DEG"):
        raise ValueError(f"unknown sencoder {cfg.sencoder!r}")


def load_raw(cfg: ExperimentConfig) -> RawLinkData:
    if cfg.dataset.startswith("ogbl-"):
        return from_ogb(cfg.dataset)
    if cfg.dataset.startswith("fixture-"):
        return fixture_link_data(cfg.dataset.split("-", 1)[1])
    if cfg.dataset.startswith("npz:"):
        # a RawLinkData npz export; name the file after the dataset (e.g.
        # ogbl-collab.npz) so the per-dataset overrides match
        return npz_link_data(cfg.dataset[4:])
    if "synth" in cfg.dataset:
        return synthetic_link_data(
            num_nodes=cfg.synth_nodes, num_edges=cfg.synth_edges,
            seed=cfg.seed, num_feature=16 if cfg.use_raw else 0,
            mrr_style=("MRR" in cfg.metric))
    raise NotImplementedError(cfg.dataset)


def load_hetero(cfg: ExperimentConfig,
                rng: np.random.Generator) -> DEHDataset:
    """A MAG relation (the reference's main.py:131-133): `synth*` a random
    one, `npz:<file>` an export, else the reference's pickle
    `./dataset/sgrl/{dataset}_{relation}.pl`."""
    kw = dict(mask_ratio=cfg.train_ratio, k=cfg.k, rng=rng)
    if "synth" in cfg.dataset:
        return synthetic_hetero_data(relation=cfg.relation, seed=cfg.seed,
                                     **kw)
    if cfg.dataset.startswith("npz:"):
        # keep 'mag' in the file name, so that the dataset routes here
        return DEHDataset.from_npz(cfg.dataset[4:], **kw)
    return DEHDataset.from_pickle(
        f"./dataset/sgrl/{cfg.dataset}_{cfg.relation}.pl", cfg.relation,
        **kw)


def load_link_data(cfg: ExperimentConfig, rng: np.random.Generator,
                   logger) -> LinkData:
    """The data prep, drawing from `rng` in the JAX CLI's order: the mask
    permutation and the training negatives (the dataset's `process`),
    then the valid and test query edges. A dataset with 'mag' in its name
    is a MAG relation (`load_hetero`), whose queries come from its splits
    and its predicted relation's train edges."""
    if "mag" in cfg.dataset:
        ds = load_hetero(cfg, rng)
        split_edge, edge_index = ds.split_edge, ds.train_edge.T
    else:
        raw = load_raw(cfg)
        ds = LinkPropDataset(
            raw, mask_ratio=cfg.train_ratio, k=cfg.k,
            use_weight=cfg.use_weight, use_coalesce=cfg.use_weight,
            use_feature=cfg.use_raw, use_val=cfg.use_val, rng=rng,
            vessel_mode=("vessel" in cfg.dataset))
        split_edge, edge_index = raw.split_edge, raw.edge_index
    graphs = ds.process(logger)

    train_edge = (ds.pos_edge.T.astype(np.int32),
                  ds.neg_edge.T.astype(np.int32))
    val_edge = get_pos_neg_edges("valid", split_edge, edge_index,
                                 ds.num_nodes, percent=cfg.valid_perc,
                                 rng=rng)
    test_edge = get_pos_neg_edges("test", split_edge, edge_index,
                                  ds.num_nodes, rng=rng)
    return LinkData(ds, graphs, train_edge,
                    {"valid": val_edge, "test": test_edge})


def _scalar_pipeline(cfg: ExperimentConfig, G: CSRGraph, logger,
                     save_load: bool = False):
    """The PPR / SPD / DEG sets of every node of G (the reference's
    main.py:181-202): the top-k PPR matrix of the host push, normalized
    'sym', with the save / load npz cache of the inference graph's
    matrix where `save_load`, then `encoding` and the padded layout."""
    from scipy.sparse import load_npz, save_npz

    ppr_path = (f"{cfg.dataset}_z_{cfg.alpha}_{cfg.topk}_{cfg.eps}.npz"
                if save_load else None)
    if save_load and cfg.load_ppr:
        try:
            x = load_npz(ppr_path)
        except FileNotFoundError:
            logger.info("%s does not exist.", ppr_path)
            raise
    else:
        idx = np.arange(G.num_nodes)
        x = topk_ppr_matrix(G, cfg.alpha, cfg.eps, idx, cfg.topk,
                            normalization="sym", nthreads=cfg.nthread)
        if save_load and cfg.save_ppr:
            save_npz(ppr_path, x.tocsr())
    x, _ = encoding(x.tocsr(), G.to_scipy(), cfg.sencoder)
    return scalar_spg_from_csr(x.tocsr())


def width_classes(cfg: ExperimentConfig, bucket: int) -> Tuple[int, ...]:
    """`--balance_widths`' classes, ascending, completed by the bucket
    width where the last is narrower."""
    classes = tuple(sorted(int(w) for w in cfg.balance_widths.split(",")))
    if classes[-1] < bucket:
        classes = classes + (bucket,)
    return classes


def node_features(cfg: ExperimentConfig, ds):
    """The raw node features [N, F] with --use_raw (None where the dataset
    has none), and with --use_pretrain the pretrained embeddings of
    `pretrain_embedding.pt` in the working directory appended (the
    reference's main.py:157-160)."""
    feature = getattr(ds, "x", None) if cfg.use_raw else None
    if cfg.use_raw and cfg.use_pretrain and feature is not None:
        pre = torch.load("pretrain_embedding.pt", map_location="cpu").numpy()
        feature = np.concatenate([feature, pre], axis=-1)
    return feature


def device_engine(engine: str, device: torch.device) -> bool:
    """Whether `--engine` runs the device engine on `device`: "device"
    does, "auto" does on the card and not on the CPU (the JAX CLI's
    choice on a CPU backend)."""
    return engine == "device" or (engine == "auto"
                                  and torch.device(device).type != "cpu")


def run_experiment(cfg: ExperimentConfig, logger=None,
                   device="cuda") -> Dict:
    """Returns {'best': [(valid, test) per run, None for a resumed run
    that ended before an evaluation], 'results': ResultLogger,
    'trainer': the training DeviceTrainer or LinkPredictor, its model as
    the last run left it, 'edges': the training query edges [2, E] (on
    the device for the device engine, on the host for the host engine)};
    with --inf_only --load_model, {'results': the evaluation}. The phase
    timer is reset first, so its report covers this call."""
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
    if cfg.debug:
        capture_stdout(logger)

    with metrics.phase("load"):
        data = load_link_data(cfg, rng, logger)
    G_obsrv, G_inf = data.graphs["train"], data.graphs["test"]

    prep_start = time.time()
    feature = node_features(cfg, data.ds)
    x_dim = feature.shape[1] if feature is not None else data.ds.num_feature
    tcfg = TrainConfig(batch_size=cfg.batch_size, lr=cfg.lr,
                       epochs=cfg.epochs, eval_steps=cfg.eval_steps,
                       early_stop=cfg.early_stop, seed=cfg.seed)
    bucket = cfg.bucket if cfg.bucket and cfg.bucket > 0 else None
    use_device_engine = device_engine(cfg.engine, device)
    scalar = cfg.sencoder != "LP"
    fused = {"auto": None, "on": True, "off": False}[cfg.fused_hidden]
    # the device engine computes in bfloat16, the host engine in float32;
    # undrawn: each run's `trainer.init` draws the weights
    model = Net(input_dim=1 if scalar else cfg.num_steps,
                hidden_dim=cfg.hidden_channels, out_dim=1, x_dim=x_dim,
                dropout=cfg.dropout, use_feature=cfg.use_raw,
                aggrs=cfg.aggrs,
                dtype="bfloat16" if use_device_engine else "float32",
                fused_hidden=fused, key=None, device=device)
    feat_dev = (None if feature is None else
                torch.as_tensor(feature, dtype=torch.float32).to(device))
    seeds = lambda G: np.arange(G.num_nodes, dtype=np.int32)
    if scalar:
        x_spg = _scalar_pipeline(cfg, G_obsrv, logger)
        z_spg = _scalar_pipeline(cfg, G_inf, logger, save_load=True)
        if use_device_engine:
            trainer, scorer = (scalar_trainer_from_spg(
                model, spg, tcfg, feature=feat_dev, device=device)
                for spg in (x_spg, z_spg))
        else:
            trainer, scorer = (ScalarLinkPredictor(
                model, spg, tcfg, feature=feature, device=device)
                for spg in (x_spg, z_spg))
    elif use_device_engine:
        x_keys, z_keys = (subg_matrix_device_keys(
            G, seeds(G), num_walks=cfg.num_walks, num_steps=cfg.num_steps,
            seed=cfg.seed, bucket=bucket, device=device)
            for G in (G_obsrv, G_inf))
        # both stores come from one cfg, so they share the key layout that
        # trainer_from_keys sets on the shared model
        trainer = trainer_from_keys(model, x_keys, tcfg, feature=feat_dev)
        scorer = trainer_from_keys(model, z_keys, tcfg, feature=feat_dev)
    else:
        trainer, scorer = (LinkPredictor(model, subg_matrix(
            G, seeds(G), num_walks=cfg.num_walks, num_steps=cfg.num_steps,
            seed=cfg.seed, bucket=bucket, device=device), tcfg,
            feature=feature, device=device) for G in (G_obsrv, G_inf))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger.info("Prep. Runtime (%s): %.2fs", cfg.sencoder,
                time.time() - prep_start)
    metrics.add("prep", time.time() - prep_start)

    edges = np.concatenate(data.train_edge, axis=1)
    labels = np.concatenate([
        np.ones(data.train_edge[0].shape[1], np.float32),
        np.zeros(data.train_edge[1].shape[1], np.float32)])
    if use_device_engine:
        edges_dev = torch.as_tensor(edges, dtype=torch.int64).to(device)
        labels_dev = torch.as_tensor(labels).to(device)
        inf_dev = {split: tuple(torch.as_tensor(e, dtype=torch.int64).to(
            device) for e in pair) for split, pair in data.inf_edge.items()}
        if cfg.balance_widths:
            classes = width_classes(cfg, trainer.rows[0].shape[1])
            logger.info("balanced-width batching: classes %s", classes)

            def run_epochs(n, key):
                return trainer.fit_balanced(edges, labels_dev, n, key,
                                            classes)[:2]
        else:
            def run_epochs(n, key):
                return trainer.fit(edges_dev, labels_dev, n, key)

        def run_eval():
            return evaluate_device(scorer, inf_dev, cfg.metric)
    else:
        edges_dev = edges

        def run_epochs(n, key):
            # the epoch permutations continue the data prep's generator,
            # the dropout keys split the block's key an epoch
            losses, aucs = zip(*(trainer.train_epoch(edges, labels, rng, sub)
                                 for sub in prng.split(key, n)))
            return torch.tensor(losses), torch.tensor(aucs)

        def run_eval():
            return evaluate(scorer, data.inf_edge, cfg.metric)

    if cfg.inf_only and cfg.load_model:
        model.load_state_dict(load_checkpoint(cfg.load_model)["params"])
        results, d_inf = run_eval()
        logger.info("inference-only results: %s (T_test %.2fs)",
                    results, d_inf)
        return {"results": results}

    rlog = ResultLogger(runs=cfg.runs, metric=cfg.metric,
                        early_stop=cfg.early_stop)
    stamp = time.strftime("%m%d%y_%H%M%S")
    model_dir = f"{cfg.log_dir}/{cfg.dataset}/model"
    for run in range(cfg.runs):
        # the weights and the epochs' draws from the JAX CLI's key tree
        trainer.init(prng.prng_key(cfg.seed + run))
        key = prng.prng_key(cfg.seed + 1000 + run)
        epoch = 0
        if cfg.resume and run == 0:
            # the weights, Adam's state, the epoch key (JAX's two words)
            # and the numpy generator as they were after the checkpoint's
            # epoch
            state = load_checkpoint(cfg.resume)
            model.load_state_dict(state["params"])
            trainer.optimizer.load_state_dict(state["opt_state"])
            key = prng.as_key(state["key"])
            rng.bit_generator.state = state["rng"]
            epoch = int(state["epoch"]) + 1
            logger.info("resumed from %s at epoch %d", cfg.resume, epoch)
        while epoch < cfg.epochs:
            # train up to and including the next eval epoch (e where
            # e % eval_steps == 0) as one block
            n = (1 - epoch) % cfg.eval_steps
            if n == 0:
                n = cfg.eval_steps
            n = min(n, cfg.epochs - epoch)
            key, sub = prng.split(key)
            with metrics.phase("train_epoch", items=edges.shape[1] * n):
                losses, aucs = (x.cpu().numpy() for x in run_epochs(n, sub))
            for i in range(n):
                logger.info("Run: %02d, Epoch: %02d, Loss: %.4f, "
                            "AUC: %.4f", run + 1, epoch + i,
                            float(losses[i]), float(aucs[i]))
            epoch += n
            last = epoch - 1
            if last % cfg.eval_steps == 0:
                save_checkpoint(
                    {"params": model.state_dict(),
                     "opt_state": trainer.optimizer.state_dict(),
                     "epoch": last,
                     "key": torch.from_numpy(prng.key_words(key)),
                     "rng": rng.bit_generator.state},
                    f"{model_dir}/latest_{run}")
                with metrics.phase("eval"):
                    results, d_inf = run_eval()
                logger.info("eval: %s (T_test %.2f)", results, d_inf)
                if rlog.add_result(run, results):
                    save_checkpoint(
                        {"params": model.state_dict(), "epoch": last},
                        f"{model_dir}/{stamp}_{run}")
                    break
        if rlog.evaluated(run):
            rlog.print_statistics(run=run, logger=logger)
    evaluated = [rlog.evaluated(r) for r in range(cfg.runs)]
    if cfg.runs > 1 and all(evaluated):
        rlog.print_statistics(logger=logger)
    metrics.log_report(logger)
    return {"results": rlog,
            "best": [rlog.best(r) if ok else None
                     for r, ok in enumerate(evaluated)],
            "trainer": trainer, "edges": edges_dev}


def card_device(device, what: str) -> torch.device:
    """`device` as a torch.device; a CUDA device where there is none
    raises (`what` names the caller in the message): entry points never
    fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the CUDA device, and there is "
                           f"none (pass device='cpu', or set "
                           f"SUREL_PLATFORM=cpu, for a CPU run)")
    return device


def platform_device() -> str:
    """The device `main` runs on: the CPU when SUREL_PLATFORM=cpu, else
    the CUDA device, which must exist."""
    platform = os.environ.get("SUREL_PLATFORM", "cuda")
    if platform == "cpu":
        return "cpu"
    if platform != "cuda":
        raise ValueError(f"SUREL_PLATFORM={platform!r}: this port runs on "
                         f"'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: set SUREL_PLATFORM=cpu to run "
                           "on the CPU")
    return "cuda"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SUREL+ on PyTorch/CUDA: link prediction")
    add_config_args(parser)
    args = parser.parse_args(argv)
    cfg = apply_dataset_overrides(config_from_args(args))
    out = run_experiment(cfg, device=platform_device())
    print(out.get("best"))


if __name__ == "__main__":
    main()
