"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration (`perfbench/configs/<config>.json`), its
traffic mix (`perfbench/traffic/<mix>.json`) and the kind of traffic the
mix names (`perfbench/kinds/<kind>.py`), its limits
(`perfbench/limits/<cell>.json`) and its per-layer readers
(`perfbench/metrics/<metric>.py`) are found by the names in
BENCHMARK.json and in those files. The last line on standard output is one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the numbers compared with their limits, which also
end standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "surel_plus_tpu")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".cache" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, mix, limits and per-layer metrics
    from BENCHMARK.json and the files named after them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json"
                          ).read_text())
    limits_file = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


def reader(name: str):
    """The per-layer metric's reader, `perfbench/metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def measure(spec: dict, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """Set up the cell, run its window (and with `trace` its traced
    window), check it against the reference; returns the result line."""
    import torch

    from perfbench import drive

    ctx = drive.Ctx(spec["cell"]["name"], spec["config"], spec["traffic"],
                    seed, seconds, trace, torch.device(device),
                    int(spec["cell"]["chips"]))
    cell = drive.kind(spec["traffic"]["kind"])(ctx, spec["limits"])
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    cell.setup()
    drive.sync(ctx.device)
    setup_s = time.perf_counter() - t0
    start = len(cell.ran)
    window_s = drive.window(cell, seconds)
    window_ran = cell.ran[start:]
    work = cell.work
    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    breakdown = None
    device_info: dict = {}
    cell.finish()
    if not trace:
        rate = work / window_s
        for m in spec["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else rate
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        t, traced = cell.traced_window()
        readings = cell.readings(window_s, window_ran, t, traced)
        for m in spec["per_layer"]:
            value = reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[
                    m["name"]]}
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = t.breakdown()
    peak = cell.memory_peak()
    checks = cell.check()
    found = forbidden_modules()
    if found:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        raise SystemExit(3)
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": work,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if ctx.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(ctx.device)
                     if ctx.device.type == "cuda" else "cpu"),
            "count": ctx.chips,
            "memory_peak_bytes": int(peak),
            **device_info,
            "power_limit": power_limit() if ctx.device.type == "cuda"
            else None,
            "window_work": work,
            "window_seconds": window_s,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    spec = load_cell(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(spec, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", T0)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
