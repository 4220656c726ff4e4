"""A fixture row of the port's CLI trained over the JAX package's sets.

A CLI row samples its packed-key sets once, from `--seed`, before its
first run, so every run of the row trains over one draw of the sets. This
script runs a row of the port's CLI with the JAX package's draw in place
of the port's, to tell whether a row's gap to the JAX row comes from the
draw of the sets: the data prep is JAX's draw for draw (the CPU tests),
so with JAX's sets only the weights' initialization, the batch orders and
the dropout masks still differ.

Two steps, from the repository root:

    # on the CPU (imports the JAX package for its sampler only): sample
    # the observed and the inference graph's sets at the row's flags, as
    # the JAX CLI does, and save them
    python results/torch_h100/over_jax_sets.py save \\
        --out .cache/jax_sets/collabs_m50.npz --dataset fixture-collabs \\
        --num_walks 50 --num_steps 3 --k 10

    # on the GPU (imports no JAX): the port's CLI over those sets, with
    # the row's flags (the same data flags as the save) and its log dir
    python results/torch_h100/over_jax_sets.py run \\
        --sets .cache/jax_sets/collabs_m50.npz --dataset fixture-collabs \\
        --num_walks 50 --num_steps 3 --k 10 --aggrs attn --epochs 20 \\
        --eval_steps 2 --early_stop 10 --runs 6 --batch_size 4096 \\
        --log_dir LOG_DIR
"""

import argparse
import dataclasses
import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from surel_plus_tpu_torch.cli import main as cli  # noqa: E402
from surel_plus_tpu_torch.spg import SpGKeys  # noqa: E402
from surel_plus_tpu_torch.utils.config import (  # noqa: E402
    add_config_args,
    apply_dataset_overrides,
    config_from_args,
)
from surel_plus_tpu_torch.utils.seeding import set_random_seed  # noqa: E402

GRAPHS = ("observed", "inference")    # the CLI samples them in this order
FIELDS = ("nodes", "khi", "klo", "sizes")


def save(cfg, out):
    """JAX's sets of the CLI's observed and inference graphs (the port's
    data prep, which is JAX's), as int32 arrays in one npz."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from surel_plus_tpu.graph.csr import CSRGraph as JaxCSRGraph
    from surel_plus_tpu.ops import sampler as jax_sampler

    data = cli.load_link_data(cfg, set_random_seed(cfg.seed),
                              logging.getLogger(__name__))
    bucket = cfg.bucket if cfg.bucket and cfg.bucket > 0 else None
    arrays = {}
    for name, split in zip(GRAPHS, ("train", "test")):
        g = data.graphs[split]
        k = jax_sampler.subg_matrix_device_keys(
            JaxCSRGraph(indptr=g.indptr, indices=g.indices, data=g.data),
            np.arange(g.num_nodes, dtype=np.int32),
            num_walks=cfg.num_walks, num_steps=cfg.num_steps, seed=cfg.seed,
            bucket=bucket)
        for f in FIELDS:
            arrays[f"{name}_{f}"] = np.asarray(getattr(k, f)).view(np.int32)
        arrays[f"{name}_layout"] = np.array([k.num_walks, k.num_steps])
        print(f"{name}: {g.num_nodes} nodes, sets "
              f"{arrays[f'{name}_nodes'].shape}", flush=True)
    np.savez_compressed(out, **arrays)


def run(cfg, sets_path):
    """The port's `run_experiment` with its two sampler calls answered by
    the saved sets, in the CLI's order."""
    saved = np.load(sets_path)
    calls = iter(GRAPHS)

    def jax_keys(graph, seeds, num_walks, num_steps, seed, bucket, device):
        name = next(calls)
        layout = tuple(int(x) for x in saved[f"{name}_layout"])
        nodes = saved[f"{name}_nodes"]
        if nodes.shape[0] != graph.num_nodes or layout != (
                num_walks, num_steps - 1):
            raise ValueError(f"the saved {name} sets ({nodes.shape[0]} "
                             f"nodes, layout {layout}) are not this row's")
        t = lambda f: torch.as_tensor(saved[f"{name}_{f}"]).to(device)
        return SpGKeys(*(t(f) for f in FIELDS), *layout)

    cli.subg_matrix_device_keys = jax_keys
    out = cli.run_experiment(cfg, device=cli.platform_device())
    print(out["best"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("save", "run"))
    ap.add_argument("--out", help="save: the npz to write")
    ap.add_argument("--sets", help="run: the npz that save wrote")
    add_config_args(ap)
    args = ap.parse_args()
    cfg = apply_dataset_overrides(config_from_args(args))
    print(dataclasses.asdict(cfg), flush=True)
    if args.mode == "save":
        save(cfg, args.out)
    else:
        run(cfg, args.sets)


if __name__ == "__main__":
    main()
