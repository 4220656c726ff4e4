"""The readings behind each limit: a cell's set-up and check, without its
measured window, over many seeds in one process.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \
        [--control | --fault "half the batch"]

Without --control the program runs as its configuration states: these
are the lower readings (training's numbers come from the checked call
of set-up, scoring's from the checked block of the first pass,
sampling's from a pass). With --control the kind's control stands in
(`Cell.control_config`, `Cell.control`): the program's own bfloat16 path
for the model cells; for the sampler, which states no precision, the
sets of a neighbouring walk key, which breaks the guarantee that a
pass's sets are its key's. With --fault the program
runs as configured with one of `perfbench/faults.py`'s faults planted:
a training cell's upper readings. Each seed prints one JSON line of the
numbers compared.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from perfbench import faults, run


def readings(workload: str, seeds, control: bool, device="cuda:0",
             spec=None):
    """Yields (seed, {number: value}) for each seed."""
    import torch

    from perfbench import drive

    spec = spec or run.load_cell(workload)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    cls = drive.kind(spec["traffic"]["kind"])
    config = cls.control_config(spec["config"]) if control \
        else dict(spec["config"])
    for seed in seeds:
        ctx = drive.Ctx(workload, config, spec["traffic"], seed, 0.0, False,
                        torch.device(device), int(spec["cell"]["chips"]))
        cell = cls(ctx, spec["limits"])
        cell.setup()
        cell.finish()
        if control:
            cell.control()
        yield seed, {c.name: c.value for c in cell.check()}
        del cell
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    how = p.add_mutually_exclusive_group()
    how.add_argument("--control", action="store_true")
    how.add_argument("--fault", choices=faults.FAULTS)
    args = p.parse_args(argv)
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    with (faults.planted(args.fault) if args.fault
          else contextlib.nullcontext()):
        for seed, values in readings(args.workload, seeds, args.control):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": args.control,
                              "fault": args.fault, "time": time.time(),
                              **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
