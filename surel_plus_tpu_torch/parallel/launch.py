"""Start the ranks of a multi-device run as local processes (the torch idiom
for what JAX's SPMD program over a mesh does in one process).

`run_ranks(target, world_size, backend, device, payload_dir, timeout_s)`
starts one `python -m surel_plus_tpu_torch.parallel.launch` process a
rank. Each joins the process group through a `FileStore` in
`payload_dir` (no TCP port to race for), with a group timeout of at most
GROUP_TIMEOUT_S, runs torch on one thread, calls `target` ("module:
function") with its `RankContext`, and writes the function's result with
`torch.save` to `payload_dir/rank<r>.pt`. If a rank exits non-zero or the
wall-clock limit passes, every rank is killed and `run_ranks` raises with
the failed ranks' output; otherwise it returns the results in rank order.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from surel_plus_tpu_torch.parallel.mesh import (
    check_backend,
    default_backend,
    rank_device,
)

GROUP_TIMEOUT_S = 120
# how long a launch waits, after a rank fails, for its peers' failures
FAIL_GRACE_S = 2.0
ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class RankContext:
    """What a rank's target gets: its rank, the world size, the backend,
    its device and the payload directory the caller shares with it."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    payload_dir: str


def _log_tail(path: Path, limit: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-limit:]


def run_ranks(target: str, world_size: int, backend: Optional[str] = None,
              device="cuda", payload_dir: Optional[str] = None,
              timeout_s: float = 300.0, sys_path: Sequence[str] = ()
              ) -> List[Any]:
    """Run `target` ("module:function", called with a RankContext) in
    `world_size` rank processes on `device` ("cuda": rank r on
    cuda:(r % cards); "cpu"). The backend defaults to NCCL on the card
    and gloo on the CPU; NCCL for more ranks than cards raises ValueError
    before any process starts. `payload_dir` (made if missing) holds the
    store, each rank's log and result; `sys_path` entries go first on the
    ranks' module path. Returns the targets' results in rank order."""
    backend = backend or default_backend(device)
    check_backend(backend, device, world_size)
    if payload_dir is None:
        raise ValueError("run_ranks needs a payload directory")
    pdir = Path(payload_dir)
    pdir.mkdir(parents=True, exist_ok=True)
    store = pdir / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*map(str, sys_path), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    group_s = int(min(GROUP_TIMEOUT_S, max(timeout_s, 1)))
    procs, logs = [], []
    try:
        for r in range(world_size):
            log = pdir / f"rank{r}.log"
            logs.append(log)
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "surel_plus_tpu_torch.parallel."
                     "launch", target, str(r), str(world_size), backend,
                     str(torch.device(device)), str(pdir), str(group_s)],
                    stdout=fh, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT)))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                # the peers of a failed rank fail in their collectives
                # soon after it: wait a moment so that every failure, the
                # first one's cause included, is in the report
                time.sleep(FAIL_GRACE_S)
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                raise RuntimeError(
                    f"{target}: ranks {bad} of {world_size} exited with "
                    f"codes {[codes[r] for r in bad]}:\n"
                    + "\n".join(f"--- rank {r}:\n{_log_tail(logs[r])}"
                                for r in bad))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                r = codes.index(None)
                raise RuntimeError(
                    f"{target}: rank {r} of {world_size} still running "
                    f"after {timeout_s:.0f} s:\n{_log_tail(logs[r])}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [torch.load(pdir / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def _main(argv: Sequence[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target")
    ap.add_argument("rank", type=int)
    ap.add_argument("world_size", type=int)
    ap.add_argument("backend")
    ap.add_argument("device")
    ap.add_argument("payload_dir")
    ap.add_argument("group_timeout_s", type=int)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    dev = rank_device(a.device, a.rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        a.backend, store=dist.FileStore(
            os.path.join(a.payload_dir, "store"), a.world_size),
        rank=a.rank, world_size=a.world_size,
        timeout=datetime.timedelta(seconds=a.group_timeout_s))
    try:
        module, func = a.target.split(":")
        fn = getattr(importlib.import_module(module), func)
        ctx = RankContext(rank=a.rank, world_size=a.world_size,
                          backend=a.backend, device=dev,
                          payload_dir=a.payload_dir)
        result = fn(ctx)
        out = Path(a.payload_dir) / f"rank{a.rank}.pt"
        tmp = out.with_suffix(".tmp")
        torch.save(result, tmp)
        os.replace(tmp, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
