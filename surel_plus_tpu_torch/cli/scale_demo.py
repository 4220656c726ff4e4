"""The large-graph path (port of the JAX package's `scripts/scale_demo.py`
and `scripts/bench_1m.py`), toward the paper's claim that SUREL+ samples
and trains on graphs of a billion edges on one machine.

Modes:
  device       R-MAT pairs drawn on the host in chunks
               (`rmat_pairs_chunked`), the native CSR ingest, cold
               sampling of SEEDS sets on the fresh graph (its upload, the
               first-hop shuffle and the edge tables timed apart from the
               walks), warm sampling (seed 1, shuffle seed 0), then a cold
               and a timed 4-epoch fit of Net(STEPS + 1, 96, mean, dropout
               0.1, bf16) at batch 4096 over QUERIES random queries.
  1m           `scripts/bench_1m.py`: rmat_graph(1M, 10M), 1M sets at
               M=100, S'=3 and the default bucket, a cold 2-epoch and a
               timed 4-epoch fit over 32 x 4096 queries.
  partitioned  `partition_csr` and `sample_gsets_partitioned` over RANKS
               gloo ranks that share the one card (JAX's runs on 8 CPU
               devices): the per-rank graph bytes, replicated and
               partitioned, and the sets/s.

Every stage prints its seconds, the host's RSS and, on the card, the
device's live bytes and the stage's peak (`max_memory_allocated` after
`reset_peak_memory_stats`); device and 1m also print the walk graph's
device bytes, read from the cached tensors (int32 words: 32 B a
directed edge, plus indptr).

env: N, DRAWS, SEEDS, QUERIES, WALKS, STEPS, BUCKET (RANKS: partitioned)
  python -m surel_plus_tpu_torch.cli.scale_demo device       # the card
  python -m surel_plus_tpu_torch.cli.scale_demo 1m
  python -m surel_plus_tpu_torch.cli.scale_demo partitioned
Every mode runs on the CUDA device and raises without one;
`SUREL_PLATFORM=cpu` runs it on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from surel_plus_tpu_torch.cli.main import card_device, platform_device
from surel_plus_tpu_torch.graph.csr import MAX_DEVICE_EDGES, csr_from_edges
from surel_plus_tpu_torch.graph.synthetic import (
    rmat_graph,
    rmat_pairs_chunked,
)
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels import build, hidden_sum, merge
from surel_plus_tpu_torch.ops.kernels import threefry
from surel_plus_tpu_torch.ops.sampler import (
    DEFAULT_BLOCK,
    cached_graph_bytes,
    device_graph,
    sample_gsets_device_keys,
    shuffled_indices_for,
    walk_tables_for,
)
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import trainer_from_keys

# the JAX scripts' defaults, by mode
DEFAULTS = {
    "device": dict(N=10_000_000, DRAWS=120_000_000, SEEDS=2_000_000,
                   QUERIES=16 * 4096, WALKS=50, STEPS=3, BUCKET=128),
    "partitioned": dict(N=2_000_000, DRAWS=20_000_000, SEEDS=65_536,
                        WALKS=25, STEPS=3, RANKS=8),
}
BATCH, HIDDEN, LR, EPOCHS = 4096, 96, 1e-3, 4
N_1M, WALKS_1M, STEPS_1M = 1_000_000, 100, 3
# the path's kernels: K8 (the walk words, riffle keys and dropout masks),
# K2 (the join's merge), K1 and K1 bwd (the fused mean route)
KERNELS = (threefry.KERNEL, merge.KERNEL, hidden_sum.KERNEL,
           hidden_sum.BWD_KERNEL)
PARTITION_TIMEOUT_S = 1800


def env_config(mode: str) -> dict:
    """The mode's knobs: each from its environment variable, else the JAX
    script's default."""
    return {k: int(os.environ.get(k, v)) for k, v in DEFAULTS[mode].items()}


def rss_gb() -> float:
    """The process's resident memory in GB (/proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1e6
    return float("nan")


class Stages:
    """Times stages and records, for each, its seconds, the host's RSS
    and on the card the live and peak device bytes; prints a line each."""

    def __init__(self, device: torch.device, log: Callable[[str], None]):
        self.device = device
        self.log = log
        self.t0 = time.perf_counter()
        self.rows = {}

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def run(self, name: str, fn, what: Callable = lambda out: ""):
        if self._cuda():
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self._cuda():
            torch.cuda.synchronize(self.device)
        row = dict(s=time.perf_counter() - t0, rss_gb=rss_gb(),
                   live_gb=None, peak_gb=None)
        if self._cuda():
            row["live_gb"] = torch.cuda.memory_allocated(self.device) / 1e9
            row["peak_gb"] = (torch.cuda.max_memory_allocated(self.device)
                              / 1e9)
        self.rows[name] = row
        dev = ("" if not self._cuda() else
               f", device live {row['live_gb']:.3f} GB, peak "
               f"{row['peak_gb']:.3f} GB")
        note = what(out)
        self.say(f"{name}: {row['s']:.3f} s{', ' + note if note else ''} "
                 f"(RSS {row['rss_gb']:.2f} GB{dev})")
        return out

    def say(self, msg: str) -> None:
        self.log(f"[{time.perf_counter() - self.t0:8.1f}s] {msg}")


def _build_kernels(st: Stages) -> None:
    """nvcc of the path's kernels before the timed stages (on the card)."""
    if st.device.type == "cuda":
        st.run("build", lambda: build.build_all(
            sorted({k.source for k in KERNELS})))


def _fit_stages(st: Stages, spgk, n_sets: int, queries: int, dtype: str,
                cold_epochs: int, warm_epochs: int, keys) -> dict:
    """Net(S'+1, 96, mean, dropout 0.1, `dtype`) over `spgk` at batch
    4096: `trainer.init(prng_key(0))`, a cold fit of `cold_epochs` and a
    timed one of `warm_epochs` over `queries` random queries of
    default_rng(0), the fits' keys `keys` (two). Returns the losses and
    the warm fit's queries/s."""
    def setup():
        model = Net(spgk.num_steps + 1, HIDDEN, aggrs="mean", dropout=0.1,
                    dtype=dtype, key=None, device=st.device)
        trainer = trainer_from_keys(model, spgk,
                                    TrainConfig(batch_size=BATCH, lr=LR))
        trainer.init(prng.prng_key(0))
        return trainer

    trainer = st.run("model", setup)
    rng = np.random.default_rng(0)
    q = rng.integers(0, n_sets, size=(2, queries)).astype(np.int32)
    labels = (rng.random(queries) < 0.5).astype(np.float32)
    out = {}
    for name, epochs, key in (("fit_cold", cold_epochs, keys[0]),
                              ("fit_warm", warm_epochs, keys[1])):
        losses = st.run(name, lambda: trainer.fit(q, labels, epochs, key)[0],
                        lambda ls: f"{epochs} x {queries:,} queries, "
                                   f"loss {float(ls[-1]):.4f}")
        out[f"losses_{name[4:]}"] = losses.cpu()
    out["queries_per_s"] = warm_epochs * queries / st.rows["fit_warm"]["s"]
    st.say(f"train warm: {warm_epochs} x {queries:,} queries -> "
           f"{out['queries_per_s']:,.0f} q/s")
    return out


def _sets_note(n: int):
    def note(spgk):
        return (f"{n:,} sets, L={int(spgk.nodes.shape[1])}, largest "
                f"{int(spgk.sizes.max())}")
    return note


def run_device(n: int, draws: int, seeds: int, queries: int, walks: int,
               steps: int, bucket: int, device="cuda",
               dtype: str = "bfloat16",
               log: Callable[[str], None] = print) -> dict:
    """The device mode (`scripts/scale_demo.py:main_device`'s stages in
    its order). Returns a dict: the config, `stages` (seconds, RSS, live
    and peak device GB a stage), `graph` (the CSRGraph, its device cache
    kept), `graph_bytes`, `sets` ("warm"; the cold sets are freed before
    the warm call), the warm sets/s and walked edges/s, the fits' losses
    and the warm fit's queries/s."""
    dev = card_device(device, "the large-graph path")
    if 2 * draws > MAX_DEVICE_EDGES:
        # the native build's and the device words' int32 offsets; the
        # numpy build would need about 16 times the pairs' bytes
        raise ValueError(f"{draws:,} draws give up to {2 * draws:,} "
                         f"directed entries before the coalesce, past the "
                         f"int32 offsets' {MAX_DEVICE_EDGES:,}")
    st = Stages(dev, log)
    res = dict(mode="device", device=str(dev), n=n, draws=draws,
               seeds=seeds, queries=queries, walks=walks, steps=steps,
               bucket=bucket, dtype=dtype)
    if dev.type == "cuda":
        st.say(f"device {torch.cuda.get_device_name(dev)}")
    st.say(f"N={n:,} DRAWS={draws:,} SEEDS={seeds:,} QUERIES={queries:,} "
           f"M={walks} S'={steps} bucket={bucket}")
    _build_kernels(st)
    edges = st.run("rmat", lambda: rmat_pairs_chunked(n, draws, seed=0),
                   lambda e: f"{len(e):,} directed pairs")
    g = st.run("ingest", lambda: csr_from_edges(edges, num_nodes=n,
                                                symmetrize=True),
               lambda g: f"N={g.num_nodes:,} nnz={g.num_edges:,} "
                         f"(~{g.num_edges // 2:,} undirected)")
    del edges
    gc.collect()
    res.update(graph=g, nnz=g.num_edges)

    # the cold call's parts: upload, shuffle, tables, then the walks alone
    st.run("upload", lambda: device_graph(g, dev))
    st.run("shuffle", lambda: shuffled_indices_for(g, 0, dev))
    st.run("tables", lambda: walk_tables_for(g, 0, dev))
    res["graph_bytes"] = gb = cached_graph_bytes(g, dev)
    st.say(f"graph on the device: {gb['total'] / 1e9:.3f} GB = "
           f"{gb['per_edge']:.2f} B a directed edge x {g.num_edges:,} + "
           f"indptr {gb['indptr'] / 1e9:.3f} GB (csr {gb['csr']:,} B, "
           f"shuffle {gb['shuffle']:,} B, tables {gb['walk_tables']:,} B)")

    ids = np.arange(seeds, dtype=np.int32)
    note = _sets_note(seeds)
    st.run("sample_cold", lambda: sample_gsets_device_keys(
        g, ids, num_walks=walks, num_steps=steps, seed=0, bucket=bucket,
        block_size=DEFAULT_BLOCK, device=dev), note)
    cold = sum(st.rows[k]["s"] for k in ("upload", "shuffle", "tables",
                                         "sample_cold"))
    st.say(f"sampling cold (upload + shuffle + tables + walks): {cold:.3f} "
           f"s -> {seeds / cold:,.0f} sets/s")
    spgk = st.run("sample_warm", lambda: sample_gsets_device_keys(
        g, ids, num_walks=walks, num_steps=steps, seed=1, shuffle_seed=0,
        bucket=bucket, block_size=DEFAULT_BLOCK, device=dev), note)
    dt = st.rows["sample_warm"]["s"]
    res["sets_per_s"] = seeds / dt
    res["walked_edges_per_s"] = seeds * walks * steps / dt
    spg_gb = 3 * spgk.nodes.numel() * 4 / 1e9
    st.say(f"sampling warm: {res['sets_per_s']:,.0f} sets/s "
           f"({res['walked_edges_per_s'] / 1e6:.1f}M walked edges/s); "
           f"sets' keys {spg_gb:.3f} GB (nodes, khi, klo)")
    res["sets"] = {"warm": spgk}
    root = prng.prng_key(1)
    root, k_cold = prng.split(root)
    _, k_warm = prng.split(root)
    res.update(_fit_stages(st, spgk, seeds, queries, dtype, EPOCHS, EPOCHS,
                           (k_cold, k_warm)))
    res["stages"] = st.rows
    return res


def run_1m(device="cuda", log: Callable[[str], None] = print) -> dict:
    """The 1m mode (`scripts/bench_1m.py`): rmat_graph(1M, 10M), a set
    for every node at M=100, S'=3 (seed 0 cold, seed 1 warm, each with
    its own shuffle, as there), `Net(4, 96, mean, bf16)`, a cold 2-epoch
    fit from prng_key(1) and a timed 4-epoch fit from prng_key(2) over
    32 x 4096 queries. Returns the same kind of dict as `run_device`."""
    dev = card_device(device, "the large-graph path")
    st = Stages(dev, log)
    n = N_1M
    res = dict(mode="1m", device=str(dev), n=n)
    _build_kernels(st)
    g = st.run("graph", lambda: rmat_graph(n, 10 * n, seed=0),
               lambda g: f"N={g.num_nodes:,} nnz={g.num_edges:,}")
    res.update(graph=g, nnz=g.num_edges)
    ids = np.arange(n, dtype=np.int32)
    note = _sets_note(n)
    for name, seed in (("sample_cold", 0), ("sample_warm", 1)):
        spgk = st.run(name, lambda: sample_gsets_device_keys(
            g, ids, num_walks=WALKS_1M, num_steps=STEPS_1M, seed=seed,
            device=dev), note)
    res["sets_per_s"] = n / st.rows["sample_warm"]["s"]
    res["graph_bytes"] = gb = cached_graph_bytes(g, dev)
    st.say(f"sampling warm: {res['sets_per_s']:,.0f} sets/s; graph on the "
           f"device {gb['total'] / 1e9:.3f} GB (two shuffles and their "
           f"tables)")
    res["sets"] = {"warm": spgk}
    res.update(_fit_stages(st, spgk, n, 32 * BATCH, "bfloat16", 2, 4,
                           (prng.prng_key(1), prng.prng_key(2))))
    res["stages"] = st.rows
    return res


# ------------------------------------------------------------ partitioned
_PARTS = ("indptr", "indices", "shuffled", "etab", "stab")


def partitioned_rank(ctx) -> dict:
    """A rank of the partitioned mode: its view of the saved partition
    (memory-mapped, so a rank reads only its shard), the mesh over the
    world, then `sample_gsets_partitioned` over every seed, timed."""
    from surel_plus_tpu_torch.parallel.mesh import make_mesh
    from surel_plus_tpu_torch.parallel.partition import (
        PartitionedCSR,
        sample_gsets_partitioned,
    )

    cfg = torch.load(os.path.join(ctx.payload_dir, "config.pt"))
    arrays = {k: np.load(os.path.join(ctx.payload_dir, f"{k}.npy"),
                         mmap_mode="c") for k in _PARTS}
    pcsr = PartitionedCSR(**arrays, rows_per_shard=cfg["rows_per_shard"],
                          num_nodes=cfg["num_nodes"],
                          num_shards=ctx.world_size)
    mesh = make_mesh(device=ctx.device)
    seeds = np.arange(cfg["seeds"], dtype=np.int32)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    local = sample_gsets_partitioned(pcsr, seeds, cfg["walks"],
                                     cfg["steps"], mesh, seed=0)
    if cuda:
        torch.cuda.synchronize(ctx.device)
    sample_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(ctx.device) / 1e9 if cuda
            else None)
    return dict(rank=ctx.rank, sample_s=sample_s, peak_gb=peak,
                rows=int(local.sets.nodes.shape[0]),
                largest=int(local.sets.sizes.max()))


def run_partitioned(n: int, draws: int, seeds: int, walks: int, steps: int,
                    ranks: int, device="cuda",
                    timeout_s: float = PARTITION_TIMEOUT_S,
                    log: Callable[[str], None] = print) -> dict:
    """The partitioned mode (`scripts/scale_demo.py:main_partitioned`):
    the graph of `rmat_pairs_chunked`, `partition_csr` at `ranks` shards
    (seed 0), the per-device graph bytes by the JAX script's word count
    (indices and shuffled, plus the two [E, 3] tables: 8 words an edge)
    replicated and at the largest shard, then the sets over `ranks` gloo
    ranks on `device` (`partitioned_rank`; on the card every rank shares
    the one card, its kernels built first). Returns the numbers as a
    dict."""
    from surel_plus_tpu_torch.parallel.launch import run_ranks
    from surel_plus_tpu_torch.parallel.partition import partition_csr

    dev = card_device(device, "the large-graph path")
    st = Stages(dev, log)
    where = ("the CPU" if dev.type == "cpu" else
             f"one card ({torch.cuda.get_device_name(dev)})")
    st.say(f"partitioned mode: {ranks} gloo ranks on {where}, N={n:,}")
    _build_kernels(st)
    edges = rmat_pairs_chunked(n, draws, seed=0)
    g = csr_from_edges(edges, num_nodes=n, symmetrize=True)
    del edges
    st.say(f"graph: nnz={g.num_edges:,} (RSS {rss_gb():.1f} GB)")
    pcsr = st.run("partition_csr", lambda: partition_csr(g, ranks, seed=0))
    emax = int(pcsr.indices.shape[1])
    words = 2 + (6 if pcsr.etab is not None else 0)
    res = dict(mode="partitioned", n=n, draws=draws, seeds=seeds,
               walks=walks, steps=steps, ranks=ranks, nnz=g.num_edges,
               emax=emax, words_per_edge=words,
               full_bytes=g.num_edges * 4 * words,
               part_bytes=emax * 4 * words)
    st.say(f"per-device graph bytes: replicated "
           f"{res['full_bytes'] / 1e9:.3f} GB every device; partitioned "
           f"max {res['part_bytes'] / 1e9:.3f} GB (Emax {emax:,}; "
           f"x{res['full_bytes'] / max(res['part_bytes'], 1):.1f} capacity "
           f"headroom)")
    with tempfile.TemporaryDirectory() as payload:
        for k in _PARTS:
            np.save(os.path.join(payload, f"{k}.npy"), getattr(pcsr, k))
        torch.save(dict(seeds=seeds, walks=walks, steps=steps,
                        rows_per_shard=pcsr.rows_per_shard, num_nodes=n),
                   os.path.join(payload, "config.pt"))
        del pcsr
        ranks_out = st.run("ranks (started, sampled)", lambda: run_ranks(
            "surel_plus_tpu_torch.cli.scale_demo:partitioned_rank", ranks,
            "gloo", str(dev), payload, timeout_s))
    res["sample_s"] = max(r["sample_s"] for r in ranks_out)
    res["sets_per_s"] = seeds / res["sample_s"]
    res["rows"] = sum(r["rows"] for r in ranks_out)
    peaks = [r["peak_gb"] for r in ranks_out if r["peak_gb"] is not None]
    res["rank_peak_gb"] = max(peaks) if peaks else None
    st.say(f"partitioned sampling: {seeds:,} sets in "
           f"{res['sample_s']:.3f} s ({res['sets_per_s']:,.0f} sets/s over "
           f"{ranks} ranks on {where}; the rank processes' start not "
           f"included)" + (f"; peak device memory a rank "
                           f"{res['rank_peak_gb']:.3f} GB" if peaks else ""))
    res["stages"] = st.rows
    return res


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "device"
    if mode == "partitioned":
        c = env_config(mode)
        return run_partitioned(c["N"], c["DRAWS"], c["SEEDS"], c["WALKS"],
                               c["STEPS"], c["RANKS"], platform_device())
    if mode == "1m":
        return run_1m(platform_device())
    if mode == "device":
        c = env_config(mode)
        return run_device(c["N"], c["DRAWS"], c["SEEDS"], c["QUERIES"],
                          c["WALKS"], c["STEPS"], c["BUCKET"],
                          platform_device())
    raise SystemExit(f"unknown mode {mode!r}: device, 1m or partitioned")


if __name__ == "__main__":
    main()
