"""The (data, graph) mesh over torch.distributed ranks (the torch form of
the JAX package's `Mesh` and its named-axis collectives, parallel/dist.py).

One process is one rank and owns one device. World rank r sits at mesh
coordinates (d, g) = (r // gp, r % gp), the row-major order of JAX's
`np.asarray(devices).reshape(data_axis, graph_axis)`. An `Axis` is the
set of ranks a named collective runs over, with this rank's index in it:

* "graph": the gp ranks of one data index (the row-sharded set store);
* "data": the dp ranks of one graph index (the batch shards);
* "world": every rank (the seed-sharded samplers).

`psum` is an all_reduce(SUM) on the axis' group, `pmean` the same divided
by the axis size (gloo has no AVG), `all_gather` stacks every member's
tensor in axis order, `all_to_all` exchanges the blocks of dim 0 (and
`all_to_all_v` blocks of given sizes). Every group is made with
`dist.new_group` by every rank in the same order; an axis of one rank
makes no group and its collectives are the identity.

The backend and the device are explicit. Rank r runs on
cuda:(r % torch.cuda.device_count()) for device "cuda" and on the CPU for
"cpu". NCCL is the default on the card and gloo on the CPU; ranks that
share a card must take gloo (NCCL refuses two ranks on one GPU), and
`check_backend` raises a ValueError before NCCL would. gloo takes CUDA
tensors for every collective here and stages them through host memory
itself (torch 2.11 on the H100 does so for all of them: chip_smoke.py's
multi-device phase runs four gloo ranks on one card), so nothing is
copied by hand, and nothing switches backend or device on a failure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    """NCCL for ranks on the card, gloo for ranks on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, local_world_size: int,
                  cards: Optional[int] = None) -> None:
    """Raise ValueError unless `backend` can join `local_world_size` ranks
    of one host on `device`: NCCL needs CUDA and one card a rank (`cards`,
    by default torch.cuda.device_count()); gloo takes the CPU or shared
    cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no ranks on device {device}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("NCCL runs on CUDA devices only; take gloo "
                             "for ranks on the CPU")
        cards = torch.cuda.device_count() if cards is None else cards
        if local_world_size > cards:
            raise ValueError(
                f"NCCL refuses two ranks on one GPU: {local_world_size} "
                f"ranks, {cards} cards; take backend='gloo' for ranks "
                f"that share a card")


def rank_device(device, rank: int) -> torch.device:
    """The device of world rank `rank`: cuda:(rank % cards) for "cuda",
    the CPU for "cpu"."""
    kind = torch.device(device).type
    if kind == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    if kind == "cpu":
        return torch.device("cpu")
    raise ValueError(f"no ranks on device {device}")


@dataclasses.dataclass
class Axis:
    """The ranks of one named axis: their group (None: the default group,
    every rank), their count and this rank's index among them."""

    group: Optional[dist.ProcessGroup]
    size: int
    index: int

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, in place; returns `t`."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the axis (a sum divided by the size), in place."""
        if self.size > 1:
            self.psum(t).div_(self.size)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every member's `t` in axis order."""
        t = t.contiguous()
        if self.size == 1:
            return t[None]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t [size, ...]: block j goes to member j; returns [size, ...]
        whose block j came from member j."""
        if self.size == 1:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_to_all_v(self, t: torch.Tensor, send: Sequence[int],
                     recv: Sequence[int]) -> torch.Tensor:
        """Uneven exchange over dim 0: the first send[0] rows of `t` go to
        member 0, the next send[1] to member 1, ...; returns the rows
        received, recv[j] of them from member j, in member order."""
        t = t.contiguous()
        out = t.new_empty((int(sum(recv)),) + tuple(t.shape[1:]))
        if self.size == 1:
            out.copy_(t)
            return out
        dist.all_to_all_single(out, t, [int(x) for x in recv],
                               [int(x) for x in send], group=self.group)
        return out


def _axis_groups(blocks: Sequence[Sequence[int]], rank: int) -> Axis:
    """The Axis of `rank` among disjoint rank lists that cover the world,
    each made a group (every rank calls new_group for every list, in the
    same order)."""
    size = len(blocks[0])
    mine = None
    for ranks in blocks:
        group = dist.new_group(list(ranks)) if size > 1 else None
        if rank in ranks:
            mine = Axis(group, size, list(ranks).index(rank))
    return mine


@dataclasses.dataclass
class Mesh:
    """A (data, graph) mesh over the initialized world: `shape` {"data":
    dp, "graph": gp}, this rank's coordinates, its device and backend, and
    the "data", "graph" and "world" axes."""

    shape: Dict[str, int]
    rank: int
    data_index: int
    graph_index: int
    device: torch.device
    backend: str
    axes: Dict[str, Axis]
    _groups: Dict[int, Axis] = dataclasses.field(default_factory=dict)

    @property
    def world_size(self) -> int:
        return self.shape["data"] * self.shape["graph"]

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    def grouped(self, group_size: int) -> Axis:
        """The axis of this rank's replica group: world ranks in
        contiguous blocks of `group_size` (made once per size, by every
        rank)."""
        if group_size not in self._groups:
            n = self.world_size
            if group_size < 1 or n % group_size:
                raise ValueError(f"group size {group_size} does not divide "
                                 f"the world {n}")
            blocks = [range(s, s + group_size)
                      for s in range(0, n, group_size)]
            self._groups[group_size] = _axis_groups(blocks, self.rank)
        return self._groups[group_size]


def make_mesh(graph_axis: Optional[int] = None, device="cuda") -> Mesh:
    """The (data, graph) mesh over every rank of the initialized process
    group. graph_axis defaults to JAX's rule: 2 where the world is even,
    else 1. Ranks run on `rank_device(device, rank)`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.launch.run_ranks or "
                           "partition.init_distributed)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if graph_axis is None:
        graph_axis = 2 if (n % 2 == 0 and n >= 2) else 1
    if graph_axis < 1 or n % graph_axis:
        raise ValueError(f"graph axis {graph_axis} does not divide the "
                         f"world {n}")
    gp, dp = graph_axis, n // graph_axis
    d, g = divmod(rank, gp)
    axes = {
        "graph": _axis_groups([range(i * gp, (i + 1) * gp)
                               for i in range(dp)], rank),
        "data": _axis_groups([range(j, n, gp) for j in range(gp)], rank),
        "world": Axis(None, n, rank),
    }
    return Mesh(shape={"data": dp, "graph": gp}, rank=rank, data_index=d,
                graph_index=g, device=rank_device(device, rank),
                backend=dist.get_backend(), axes=axes)
