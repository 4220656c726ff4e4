"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file: configurations, mixes, limits and per-layer readers."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from perfbench import drive, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            keys = ("why", "layer") + (("source",) if group == "configs"
                                       else ())
            for key in keys:
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text
    assert len(names) == len(set(names))


def test_end_to_end_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_found_and_reduced():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("perfbench/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found(cell):
    spec = run.load_cell(cell)
    assert spec["cell"]["chips"] == 1
    assert issubclass(drive.kind(spec["traffic"]["kind"]), drive.Cell)
    assert spec["limits"], f"perfbench/limits/{cell}.json is missing"
    e2e = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
    assert set(m["workloads"]) <= set(CELLS)
    path = ROOT / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    assert run.reader(metric) is not None


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(k) <= 200 for k in layers)
