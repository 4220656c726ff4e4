"""The shared harness: what every cell shares (its graph, sets and model,
the check of its sets, the measured window), and the kind of traffic a
mix file names, found by that name in `perfbench/kinds/<kind>.py`, whose
`Cell` class runs its set-up, calls, traced window and check.

The program under test is `surel_plus_tpu_torch`; the benchmark makes
every input (graph, queries, weights, keys) from the seed and hands the
same to the program and to the reference (`perfbench/reference`).
"""

from __future__ import annotations

import dataclasses
import importlib
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import trace as tr
from perfbench.gen import queries as gq
from perfbench.gen.graph import generator, rmat_edges
from perfbench.reference import sampler as ref_sampler
from surel_plus_tpu_torch.graph.csr import csr_from_edges
from surel_plus_tpu_torch.models.net import Net
from surel_plus_tpu_torch.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu_torch.train.device import trainer_from_keys
from surel_plus_tpu_torch.train.loop import TrainConfig


@dataclasses.dataclass
class Ctx:
    """What a run is asked: the cell, its configuration and mix, the
    seed, the window's seconds, whether to trace, the first device and
    the number of devices the cell takes."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int = 1


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the kind of traffic, the measured
    window's seconds and model FLOPs, the traced window, its units
    (steps, batches or passes), the (own slots, partner hits, queries)
    of each traced step or batch, and the sampler's words drawn in it."""
    kind: str
    config: dict
    window_s: float
    flops: Optional[float]
    trace: tr.Trace
    traced_units: int
    unit_counts: List[Tuple[float, float, float]]
    words: float = 0.0


@dataclasses.dataclass
class Check:
    """One number compared, with its limit (the number passes at or
    below it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    """Return the freed program state's memory before the reference runs."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def walk_steps(config: dict) -> int:
    """The walk steps S' of the CLI's S (`num_steps`)."""
    return int(config["num_steps"]) - 1


def gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else float(a != b)


def kind(name: str):
    """The `Cell` class of the kind of traffic `name`, from
    `perfbench/kinds/<name>.py`."""
    if not name.isidentifier():
        raise ValueError(f"no kind of traffic {name!r}")
    return importlib.import_module(f"perfbench.kinds.{name}").Cell


class Cell:
    """Shared set-up: the graph, its sets, and for the model mixes the Net
    and its trainer over the benchmark's weights. A kind's `Cell` adds
    `setup`, `step` (one call of the window), `traced_window`, `readings`
    and `check`; it may override `finish` and `memory_peak`."""

    def __init__(self, ctx: Ctx, limits: Dict[str, float]):
        self.ctx = ctx
        self.limits = limits
        self.cfg = ctx.config
        self.mix = ctx.traffic
        self.dev = ctx.device
        self.n = int(self.cfg["num_nodes"])
        self.M = int(self.cfg["num_walks"])
        self.S = walk_steps(self.cfg)
        self.block = int(self.mix["set_block"])
        self.work = 0            # queries, pairs or sets completed
        self.ran: list = []      # what each call ran, in order

    # -- set-up pieces ----------------------------------------------------
    def edges(self) -> torch.Tensor:
        return rmat_edges(self.n, int(self.cfg["num_edges"]),
                          self.ctx.seed, self.dev, **self.cfg["graph"])

    def sample_sets(self, walk_edges: torch.Tensor):
        self.walk_edges = walk_edges
        self.graph = csr_from_edges(walk_edges.cpu().numpy(),
                                    num_nodes=self.n)
        self.all_seeds = np.arange(self.n, dtype=np.int64)
        return sample_gsets_device_keys(
            self.graph, self.all_seeds, self.M, self.S, seed=self.ctx.seed,
            block_size=self.block, device=self.dev)

    def model(self, sets):
        self.weights = gq.weights(self.cfg["aggregator"], self.S + 1,
                                  int(self.cfg["hidden_dim"]), self.ctx.seed,
                                  self.dev)
        net = Net(self.S + 1, int(self.cfg["hidden_dim"]),
                  dropout=float(self.cfg["dropout"]),
                  aggrs=self.cfg["aggregator"], dtype=self.cfg["dtype"],
                  key=None, device=self.dev)
        net.load_state_dict(self.weights, strict=True)
        self.trainer = trainer_from_keys(net, sets, TrainConfig(
            batch_size=int(self.mix["batch_size"]),
            lr=float(self.cfg["lr"]),
            grad_clip=float(self.cfg["grad_clip"])))
        self.B = int(self.mix["batch_size"])

    @staticmethod
    def control_config(config: dict) -> dict:
        """The configuration of the control: the nearest lower precision
        than the one the configuration states, the program's own path."""
        return dict(config, dtype="bfloat16")

    def control(self) -> None:
        """Puts the control in place after set-up, where the configuration
        alone does not."""

    def finish(self) -> None:
        """What has to run on past the window (untimed) for the check."""

    def memory_peak(self) -> int:
        """The peak of device memory on the fullest device the run used."""
        if self.dev.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.dev))

    def with_join_span(self, fn):
        """Run `fn` with the trainer's join inside the join span."""
        join = self.trainer.join

        def spanned(*args):
            with tr.span(tr.JOIN_SPAN, True):
                return join(*args)

        self.trainer.join = spanned
        try:
            fn()
        finally:
            self.trainer.join = join

    # -- the sets against the reference --------------------------------
    def check_sets(self, sets, rows: torch.Tensor, seed: int,
                   name: str = "set_rows_wrong") -> Check:
        """The sets at `rows` (a sample drawn from the seed) against the
        reference sampler's, every word exactly: the count of rows that
        differ in nodes, sizes or either key word."""
        g = generator(self.ctx.seed, self.dev, 6)
        want = int(self.mix["checked_sets"])
        pick = rows[torch.randperm(rows.numel(), generator=g,
                                   device=rows.device)[:want]]
        pick = pick.sort().values.tolist()
        refg = ref_sampler.RefGraph(self.walk_edges, self.n)
        got = [t[pick] for t in (sets.nodes, sets.sizes, sets.khi,
                                 sets.klo)]
        exp = ref_sampler.sets(refg, [int(self.all_seeds[r]) for r in pick],
                               pick, self.M, self.S, sets.nodes.shape[1],
                               seed, self.block, self.ctx.seed)
        del refg
        bad = torch.zeros(len(pick), dtype=torch.bool, device=self.dev)
        for a, b in zip(got, exp):
            d = a.to(self.dev) != b.to(self.dev)
            bad |= d if d.dim() == 1 else d.any(dim=1)
        return Check(name, float(bad.sum()), self.limits.get(name, 0.0))


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the norms of `got` and `want`, over
    the larger of the leaf's reference norm and the median leaf's; leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (they move under Adam by round-off alone)."""
    gnorm = {k: float(v.norm()) for k, v in grads.items()}
    gmed = statistics.median(gnorm.values())
    keys = [k for k in want if gnorm[k] >= 1e-3 * gmed]
    norms = {k: float(want[k].norm()) for k in keys}
    med = statistics.median(norms.values())
    return max(gap(float(got[k].norm()), norms[k], max(norms[k], med))
               for k in keys)


def window(cell: Cell, seconds: float) -> float:
    """The measured window: the cell's calls, closed loop, until `seconds`
    have passed on the host's clock, then the device drained. Returns its
    seconds."""
    sync(cell.dev)
    t0 = time.perf_counter()
    while True:
        cell.step()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(cell.dev)
    return time.perf_counter() - t0
