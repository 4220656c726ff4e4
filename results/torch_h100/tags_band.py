"""The tags fixture's HONet row of the port against the JAX package's:
per run the test MRR at the best validation MRR (the primary rule of
scripts/summarize_fixture_results.py) from the port's run logs, JAX's
from its `.out` (the best (valid, test) per run: its log holds no eval
line), and the band |port - JAX| <= 2 sqrt(sd_JAX^2 + sd_port^2), sd the
spread over runs (numpy's std). Run from the repository root:

    python results/torch_h100/tags_band.py results/torch_h100/tags_honet*.log
"""
import ast
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_OUT = os.path.join(ROOT, "results", "jax_r5", "tags_honet12.out")


def _summarizer():
    spec = importlib.util.spec_from_file_location(
        "summarize_fixture_results",
        os.path.join(ROOT, "scripts", "summarize_fixture_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(logs):
    best = ast.literal_eval(open(JAX_OUT).read().strip())
    jax = np.array([t * 100 for _, t in best])
    print(f"JAX {os.path.relpath(JAX_OUT, ROOT)}: {jax.mean():.2f}±"
          f"{jax.std():.2f} {[f'{x:.2f}' for x in jax]}")
    summ = _summarizer()
    means = []
    for path in logs:
        runs = summ.parse(path)["MRR"]
        port = np.array([summ.select(e, False) * 100 for e in runs])
        gap = abs(port.mean() - jax.mean())
        band = 2 * np.sqrt(jax.std() ** 2 + port.std() ** 2)
        means.append(port.mean())
        print(f"{path}: {port.mean():.2f}±{port.std():.2f} "
              f"{[f'{x:.2f}' for x in port]} ({len(runs)} runs); "
              f"|port - JAX| {gap:.2f} {'<=' if gap <= band else '>'} band "
              f"{band:.2f}: {'in band' if gap <= band else 'out of band'}")
    if len(means) > 1:
        print(f"over the {len(means)} logs: {np.mean(means):.2f}±"
              f"{np.std(means):.2f}")


if __name__ == "__main__":
    main(sys.argv[1:])
