"""Per-source 1000-negative MRR evaluation at citation2 scale (port of the
JAX package's `scripts/probe_mrr_scale.py`).

The reference's main evaluation shape (train.py:245-280, utils.py:78-95):
each positive query scored against 1000 negatives of its own source.
citation2 totals 86.6M scored pairs and takes 1,389 s on an A100 (the
paper's Table 4). The probe runs that shape on one card: 80,000 sources x
(1 positive + 1000 negatives) = 80,080,000 scored pairs through the join,
the model and `device_mrr`.

Stages, in the script's order: `rmat_graph(250,000, 2,500,000)`, a set
for every node (M=100, S'=3, seed 0), `Net(S'+1, 96, mean, dropout 0.1,
bf16)` through `trainer_from_keys` at batch 4096 with the weights of
`trainer.init(prng_key(0))` (flax's `init(PRNGKey(0))`), the numpy draws
of `default_rng(0)` in the script's order and sizes (`probe_draws`), a
warm `predict` on the positives, then the timed window: the positives'
scores, the negatives scored in chunks of `chunk` pairs as they are drawn,
their concatenation and `device_mrr`, one device sync.

  python -m surel_plus_tpu_torch.cli.probe_mrr_scale          # the card
  SUREL_PLATFORM=cpu python -m surel_plus_tpu_torch.cli.probe_mrr_scale \\
    --num_nodes 2000 --num_edges 12000 --walks 8 --steps 2 --n_src 64 \\
    --k_neg 10 --chunk 200 --batch 256 --dtype float32       # CPU, toy

It runs on the CUDA device and raises without one; `SUREL_PLATFORM=cpu`
or `device="cpu"` runs it on the CPU (the kernels' plain versions). Every
line with a number carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from surel_plus_tpu_torch.cli.main import card_device, platform_device
from surel_plus_tpu_torch.graph.synthetic import rmat_graph
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels import build, hidden_sum, merge
from surel_plus_tpu_torch.ops.kernels import threefry
from surel_plus_tpu_torch.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import (
    DeviceTrainer,
    device_mrr,
    trainer_from_keys,
)

# the script's constants
NUM_NODES, NUM_EDGES = 250_000, 2_500_000
WALKS, STEPS = 100, 3
N_SRC, K_NEG = 80_000, 1000
CHUNK = 4_000_000                 # negatives scored in 4M-pair chunks
BATCH, HIDDEN, DROPOUT, LR = 4096, 96, 0.1, 1e-3
INIT_EDGES = 4096                 # the [2, 4096] example edges of its init
# the reference's citation2 evaluation on an A100 (the script's line)
A100_PAIRS, A100_S = 86.6e6, 1389.0
A100_PAIRS_PER_S = 62_350
# the path's kernels: K8 (the walk words, the init's draws), K2 (the
# join's merge), K1 (the fused mean hidden sum)
KERNELS = (threefry.KERNEL, merge.KERNEL, hidden_sum.KERNEL)


def resolve_device(device=None) -> torch.device:
    """`device`, or where it is None the CUDA device unless
    SUREL_PLATFORM=cpu (`cli.main.platform_device`). A CUDA device that
    is missing raises: the probe never falls back to the CPU."""
    if device is None:
        return torch.device(platform_device())
    return card_device(device, "the probe")


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    device's index), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(device)}, power limit " \
                  f"not read"


def probe_draws(num_nodes: int, n_src: int = N_SRC, k_neg: int = K_NEG,
                chunk: int = CHUNK, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, Iterator[np.ndarray]]:
    """The script's numpy draws of `default_rng(seed)` in its order and
    sizes: the init's example edges [2, 4096] (int32), the positives
    [2, n_src] (the sources, then their partners), and an iterator over
    the negatives' chunks, `chunk // k_neg` sources a chunk: each the
    chunk's sources repeated k_neg times and their partners [2, sources x
    k_neg], drawn from the same generator as the iterator reaches it (so
    the draws stay in the script's order, and chunks are not folded into
    one draw: a bounded draw depends on its size)."""
    per = chunk // k_neg
    if per < 1:
        raise ValueError(f"a chunk of {chunk} pairs holds no source at "
                         f"{k_neg} negatives a source")
    rng = np.random.default_rng(seed)
    init_edges = rng.integers(0, num_nodes, size=(2, INIT_EDGES)
                              ).astype(np.int32)
    src = rng.integers(0, num_nodes, n_src).astype(np.int32)
    pos_dst = rng.integers(0, num_nodes, n_src).astype(np.int32)

    def negatives():
        for lo in range(0, n_src, per):
            hi = min(lo + per, n_src)
            ns = np.repeat(src[lo:hi], k_neg)
            nd = rng.integers(0, num_nodes, (hi - lo) * k_neg
                              ).astype(np.int32)
            yield np.stack([ns, nd])

    return init_edges, np.stack([src, pos_dst]), negatives()


def probe_sets(num_nodes: int, num_edges: int, walks: int, steps: int,
               device):
    """The script's graph and its sets: `rmat_graph(num_nodes, num_edges,
    seed=0)` and a set for every node at seed 0. Returns (graph,
    SpGKeys)."""
    g = rmat_graph(num_nodes, num_edges, seed=0)
    spgk = sample_gsets_device_keys(
        g, np.arange(num_nodes, dtype=np.int32), num_walks=walks,
        num_steps=steps, seed=0, device=device)
    return g, spgk


def probe_trainer(spgk, batch: int = BATCH, dtype: str = "bfloat16",
                  device="cuda") -> DeviceTrainer:
    """`Net(S'+1, 96, mean, dropout 0.1, dtype)` through
    `trainer_from_keys` (TrainConfig(batch, lr 1e-3)), its weights those
    of `trainer.init(prng_key(0))`."""
    model = Net(spgk.num_steps + 1, HIDDEN, dropout=DROPOUT, dtype=dtype,
                key=None, device=device)
    trainer = trainer_from_keys(model, spgk,
                                TrainConfig(batch_size=batch, lr=LR))
    trainer.init(prng.prng_key(0))
    return trainer


def score_pairs(predict: Callable, pos_edges: np.ndarray,
                negatives, k_neg: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positives' scores [n], then each negative chunk's scores in
    [sources, k_neg] rows, concatenated ([n, k_neg]), from `predict`
    (edges -> scores)."""
    pos = predict(pos_edges)
    neg = torch.cat([predict(e).reshape(-1, k_neg) for e in negatives])
    return pos, neg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(num_nodes: int = NUM_NODES, num_edges: int = NUM_EDGES,
        M: int = WALKS, S: int = STEPS, n_src: int = N_SRC,
        k_neg: int = K_NEG, chunk: int = CHUNK, batch: int = BATCH,
        dtype: str = "bfloat16", device=None,
        log: Callable[[str], None] = print) -> dict:
    """The probe, the script's stages in its order (on the card its
    kernels built first). Returns a dict: the
    config, `mrr`, `pairs`, `seconds` (the timed window), `pairs_per_s`,
    `peak_gb` (device, None on the CPU), `label`, the scores (`pos`
    [n_src], `neg` [n_src, k_neg], on the device) and the `trainer`."""
    dev = resolve_device(device)
    label = card_label(dev)
    cuda = dev.type == "cuda"
    if cuda:
        # nvcc of the path's kernels before the stages
        t0 = time.perf_counter()
        build.build_all(sorted({k.source for k in KERNELS}))
        log(f"build: {time.perf_counter() - t0:.3f} s [{label}]")
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()
    g, spgk = probe_sets(num_nodes, num_edges, M, S, dev)
    largest = int(spgk.sizes.max())
    log(f"sampled {num_nodes:,} sets (M={M}, S'={S}, largest {largest}) "
        f"in {time.perf_counter() - t_start:.3f} s; device={dev} "
        f"[{label}]")

    trainer = probe_trainer(spgk, batch, dtype, dev)
    init_edges, pos_edges, negatives = probe_draws(num_nodes, n_src, k_neg,
                                                   chunk)
    del init_edges          # drawn for the stream's sake: init needs none
    total = n_src * (k_neg + 1)
    log(f"scoring {total:,} pairs ({n_src:,} sources x {k_neg} negatives "
        f"+ 1 positive), chunks of {chunk:,} pairs, batch {batch}, "
        f"{dtype} [{label}]")

    # the warm call on the positives
    _ = float(trainer.predict(pos_edges)[0])
    _sync(dev)
    t0 = time.perf_counter()
    pos, neg = score_pairs(trainer.predict, pos_edges, negatives, k_neg)
    mrr_t = device_mrr(pos, neg)
    _sync(dev)
    mrr = float(mrr_t)
    dt = time.perf_counter() - t0
    rate = total / dt
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    log(f"MRR={mrr!r} over {total:,} pairs in {dt!r} s -> {rate!r} "
        f"pairs/s [{label}]")
    log(f"reference citation2: {A100_PAIRS / 1e6}M pairs / {A100_S} s = "
        f"{A100_PAIRS / A100_S / 1e6!r}M pairs/s on an A100 -> "
        f"{rate / A100_PAIRS_PER_S!r}x [{label}]")
    log(f"peak device memory "
        f"{'not measured (CPU)' if peak is None else f'{peak!r} GB'}; "
        f"the probe {time.perf_counter() - t_start:.3f} s [{label}]")
    return dict(num_nodes=num_nodes, num_edges=num_edges, M=M, S=S,
                n_src=n_src, k_neg=k_neg, chunk=chunk, batch=batch,
                dtype=dtype, device=str(dev), label=label, mrr=mrr,
                pairs=total, seconds=dt, pairs_per_s=rate, peak_gb=peak,
                pos=pos, neg=neg, trainer=trainer, graph=g)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("num_nodes", NUM_NODES),
                          ("num_edges", NUM_EDGES), ("walks", WALKS),
                          ("steps", STEPS), ("n_src", N_SRC),
                          ("k_neg", K_NEG), ("chunk", CHUNK),
                          ("batch", BATCH)):
        ap.add_argument(f"--{name}", type=int, default=default)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    a = ap.parse_args(argv)
    res = run(a.num_nodes, a.num_edges, a.walks, a.steps, a.n_src, a.k_neg,
              a.chunk, a.batch, a.dtype, device=None)
    if not (np.isfinite(res["mrr"]) and 0 < res["mrr"] <= 1):
        raise SystemExit(f"MRR {res['mrr']} is not in (0, 1]")
    return res


if __name__ == "__main__":
    main()
