"""What the benchmark loads: nothing of JAX or of the JAX package in the
harness's process, and nothing of the program in the reference."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "surel_plus_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded(
        "import json\n"
        "import perfbench.control, perfbench.drive, perfbench.trace\n"
        "from perfbench import run\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for m in bench['per_layer']:\n"
        "    run.reader(m['name'])\n"
        "for w in bench['workloads']:\n"
        "    spec = run.load_cell(w['name'])\n"
        "    perfbench.drive.kind(spec['traffic']['kind'])\n"
        "    perfbench.reference.model.aggregator("
        "spec['config']['aggregator'])")
    assert not names & FORBIDDEN
    assert "surel_plus_tpu_torch" in names   # the program under test


def test_reference_loads_nothing_of_the_program():
    names = loaded("import perfbench.reference.model, "
                   "perfbench.reference.sampler, perfbench.reference.draws, "
                   "perfbench.reference.aggr.mean, "
                   "perfbench.reference.aggr.attn, "
                   "perfbench.gen.graph, perfbench.gen.queries, "
                   "perfbench.work")
    assert not names & (FORBIDDEN | {"surel_plus_tpu_torch"})


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device here: the run exits with an error and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "citation2-mean.sample", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, the run
    exits with an error and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "citation2-mean.sample", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
