"""PyTorch port, the link-prediction CLI on the device engine and the
host modules under it, each against the JAX package:

- the configuration (fields, defaults, per-dataset overrides, argv
  parsing) equal;
- negatives, query-edge splits and the whole data prep (masking,
  negatives, the three CSR graphs, valid and test edges) exactly equal
  from the same numpy seed, drawn in the JAX CLI's order, with the
  global `np.random.seed(123)` side effect;
- `ResultLogger`'s stop decisions, best values and statistics lines
  equal;
- an RNG-free golden of the samplers on a directed chain (every walk is
  the path i, i+1, ...): the port's `subg_matrix_device_keys` and
  `subg_matrix_device` exactly JAX's;
- the keys and table joins on a batch sliced from column-major edges
  (the CLI's layout): contiguous rows into the merge, the same join as
  row-major edges;
- `evaluate_device` on JAX-sampled keys and JAX's weights, in float32:
  scores within rtol 1e-4 (the routes sum in other orders), each result
  within 1e-6 when fed JAX's own scores (a float32 mean over another
  order), and end to end within one rank flip (1 / #positives);
- `from_ogb` on a stub `ogb.linkproppred` (torch tensors with and
  without x, edge_weight and source_node; nothing is downloaded) field
  by field JAX's, `ogbl-*` datasets routed through it, and both raising
  ImportError where `ogb` is missing;
- `run_experiment` and `main` on the CPU at a toy size (the host engine,
  balanced batching and
  the scalar encoders: tests/test_torch_port_host_engine.py; MAG:
  tests/test_torch_port_hetero.py; checkpoints, --resume, --inf_only and
  --use_pretrain: tests/test_torch_port_checkpoint.py).
"""

import argparse
import dataclasses
import importlib.util
import logging
import math
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from surel_plus_tpu.cli import main as jcli
from surel_plus_tpu.graph import datasets as jds
from surel_plus_tpu.graph.csr import CSRGraph as JaxCSRGraph
from surel_plus_tpu.graph.negative import negative_sampling as jax_negatives
from surel_plus_tpu.graph.splits import get_pos_neg_edges as jax_splits
from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import sampler as jsampler
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import evaluate_device as jax_evaluate
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu.utils import config as jconfig
from surel_plus_tpu.utils.logger import ResultLogger as JaxResultLogger
from surel_plus_tpu.utils.seeding import set_random_seed as jax_seed
from surel_plus_tpu_torch.cli import main as cli
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import datasets as tds
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.graph.csr import CSRGraph
from surel_plus_tpu_torch.graph.negative import negative_sampling
from surel_plus_tpu_torch.graph.splits import get_pos_neg_edges
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import join as join_ops
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import sampler as tsampler
from surel_plus_tpu_torch.ops.merge_net import merge_pairs
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import (
    evaluate_device,
    trainer_from_keys,
)
from surel_plus_tpu_torch.utils import config as tconfig
from surel_plus_tpu_torch.utils.logger import ResultLogger
from surel_plus_tpu_torch.utils.seeding import set_random_seed
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = logging.getLogger("test_torch_port_cli")


def _summarizer():
    spec = importlib.util.spec_from_file_location(
        "summarize_fixture_results",
        os.path.join(ROOT, "scripts", "summarize_fixture_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(pkg, argv):
    parser = argparse.ArgumentParser()
    pkg.add_config_args(parser)
    return pkg.apply_dataset_overrides(
        pkg.config_from_args(parser.parse_args(argv)))


# (a) the configuration

def test_config_fields_and_defaults_match_jax():
    def fields(cls):
        return [(f.name, f.default, str(f.type))
                for f in dataclasses.fields(cls)]
    assert fields(tconfig.ExperimentConfig) == fields(
        jconfig.ExperimentConfig)


@pytest.mark.parametrize("name", ["fixture-collabs", "fixture-cites",
                                  "synth-collab", "npz:x.npz"])
def test_dataset_overrides_match_jax(name):
    got = tconfig.apply_dataset_overrides(
        tconfig.ExperimentConfig(dataset=name, metric="Hits@20"))
    want = jconfig.apply_dataset_overrides(
        jconfig.ExperimentConfig(dataset=name, metric="Hits@20"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_argv_parses_as_jax():
    argv = ["--dataset", "fixture-collab", "--aggrs", "attn",
            "--num_walks", "200", "--num_steps", "3", "--k", "10",
            "--epochs", "30", "--eval_steps", "2", "--early_stop", "10",
            "--runs", "3", "--batch_size", "4096", "--use_weight",
            "--lr", "0.002", "--resume", "ckpt", "--fused_hidden", "off"]
    got, want = _config(tconfig, argv), _config(jconfig, argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.use_val and got.use_weight and got.lr == 0.002


# (b) negatives and query-edge splits

@pytest.mark.parametrize("force_undirected", [False, True])
def test_negative_sampling_matches_jax(force_undirected):
    edges = np.random.default_rng(3).integers(0, 40, size=(2, 300))
    got_rng, want_rng = (np.random.default_rng(9) for _ in range(2))
    got = negative_sampling(edges, 40, 500, rng=got_rng,
                            force_undirected=force_undirected)
    want = jax_negatives(edges, 40, 500, rng=want_rng,
                         force_undirected=force_undirected)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got_rng.integers(1 << 30) == want_rng.integers(1 << 30)


def _split_edge(layout, rng, n=60, e=80, k=5):
    def edges(width):
        return rng.integers(0, n, size=(e, width))

    if layout == "edge":
        return {s: {"edge": edges(2), "edge_neg": edges(2)}
                for s in ("train", "valid", "test")}
    if layout == "source_node":
        return {s: {"source_node": rng.integers(0, n, e),
                    "target_node": rng.integers(0, n, e),
                    "target_node_neg": rng.integers(0, n, size=(e, k))}
                for s in ("train", "valid", "test")}
    return {s: {"hedge": edges(3),
                "hedge_neg": rng.integers(0, n, size=(e * k, 3))}
            for s in ("train", "valid", "test")}


@pytest.mark.parametrize("percent", [100, 40])
@pytest.mark.parametrize("split", ["train", "valid"])
@pytest.mark.parametrize("layout", ["edge", "source_node", "hedge"])
def test_pos_neg_edges_match_jax(layout, split, percent):
    """Exactly JAX's edges, and the same global numpy state after."""
    se = _split_edge(layout, np.random.default_rng(5))
    edge_index = se["train"].get("edge", np.zeros((4, 2), int)).T
    out, rngs, states = [], [], []
    for fn in (get_pos_neg_edges, jax_splits):
        rng = np.random.default_rng(11)
        np.random.seed(77)
        out.append(fn(split, se, edge_index, 60, percent=percent, rng=rng))
        rngs.append(rng.integers(1 << 30))
        states.append(np.random.randint(1 << 30))
    (gp, gn), (wp, wn) = out
    for g, w in ((gp, wp), (gn, wn)):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert rngs[0] == rngs[1] and states[0] == states[1]


# (c) the data prep of the CLI

def _jax_link_data(cfg):
    """main.py:118-146 of the JAX package, its calls in its order."""
    rng = jax_seed(cfg.seed)
    if cfg.dataset.startswith("fixture-"):
        raw = jds.fixture_link_data(cfg.dataset.split("-", 1)[1])
    else:
        raw = jds.synthetic_link_data(
            num_nodes=cfg.synth_nodes, num_edges=cfg.synth_edges,
            seed=cfg.seed, num_feature=16 if cfg.use_raw else 0,
            mrr_style=("MRR" in cfg.metric))
    ds = jds.LinkPropDataset(
        raw, mask_ratio=cfg.train_ratio, k=cfg.k,
        use_weight=cfg.use_weight, use_coalesce=cfg.use_weight,
        use_feature=cfg.use_raw, use_val=cfg.use_val, rng=rng,
        vessel_mode=("vessel" in cfg.dataset))
    graphs = ds.process(QUIET)
    train_edge = (ds.pos_edge.T.astype(np.int32),
                  ds.neg_edge.T.astype(np.int32))
    val_edge = jax_splits("valid", raw.split_edge, raw.edge_index,
                          ds.num_nodes, percent=cfg.valid_perc, rng=rng)
    test_edge = jax_splits("test", raw.split_edge, raw.edge_index,
                           ds.num_nodes, rng=rng)
    return ds, graphs, train_edge, {"valid": val_edge, "test": test_edge}


@pytest.mark.parametrize("argv", [
    ["--dataset", "fixture-collabs"],
    ["--dataset", "fixture-collabs", "--use_weight", "--seed", "3"],
    ["--dataset", "fixture-cites", "--k", "5", "--valid_perc", "30"],
    ["--dataset", "synth-vessel", "--synth_nodes", "600",
     "--synth_edges", "3000"],
], ids=["collabs", "collabs_weight", "cites", "synth_vessel"])
def test_load_link_data_matches_jax(argv):
    cfg = _config(tconfig, argv)
    want_ds, want_graphs, want_train, want_inf = _jax_link_data(
        _config(jconfig, argv))
    want_state = np.random.randint(1 << 30)
    data = cli.load_link_data(cfg, set_random_seed(cfg.seed), QUIET)
    assert np.random.randint(1 << 30) == want_state
    if "collab" in argv[1]:
        assert cfg.use_val
    for got, want in zip(data.train_edge, want_train):
        np.testing.assert_array_equal(got, want)
    assert data.ds.num_pos == want_ds.num_pos
    if cfg.use_raw:
        np.testing.assert_array_equal(data.ds.x, want_ds.x)
    assert sorted(data.graphs) == sorted(want_graphs) == [
        "test", "train", "val"]
    for name, g in data.graphs.items():
        w = want_graphs[name]
        np.testing.assert_array_equal(g.indptr, w.indptr)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.data, w.data)
    for split in ("valid", "test"):
        for got, want in zip(data.inf_edge[split], want_inf[split]):
            np.testing.assert_array_equal(got, want)


# (d) the result logger

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    lg = logging.getLogger(f"test_torch_port_cli.{name}")
    lg.handlers.clear()
    lg.propagate = False
    lg.setLevel(logging.DEBUG)
    h = _Lines()
    lg.addHandler(h)
    return lg, h


@pytest.mark.parametrize("metric", ["Hits@50", "MRR"])
def test_result_logger_matches_jax(metric):
    runs, early_stop = 3, 3
    out = []
    for cls in (ResultLogger, JaxResultLogger):
        rlog = cls(runs=runs, metric=metric, early_stop=early_stop)
        lg, h = _logger(cls.__module__)
        stops = []
        draws = np.random.default_rng(4)
        for run in range(runs):
            for _ in range(9):
                v = draws.random(3)
                if run == 2:
                    v[1] = 1.0   # a saturated validation metric stops
                if "Hits" in metric:
                    res = {f"Hits@{k}": (0, float(v[1] * k / 100),
                                         float(v[2])) for k in
                           (10, 20, 50, 100)}
                else:
                    res = (0, float(v[1]), float(v[2]))
                stops.append(rlog.add_result(run, res))
                if stops[-1]:
                    break
            rlog.print_statistics(run=run, logger=lg)
        rlog.print_statistics(logger=lg)
        out.append((stops, [rlog.best(r) for r in range(runs)], h.lines))
    assert out[0] == out[1]
    assert any(out[0][0]) and not all(out[0][0])


# (e) the samplers on a directed chain, RNG-free

def _chain(n):
    """Directed chain 0 -> 1 -> ... -> n-1 (the last node is a sink)."""
    indptr = np.concatenate([np.arange(n, dtype=np.int32),
                             [n - 1]]).astype(np.int32)
    return indptr, np.arange(1, n, dtype=np.int32)


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("num_walks,num_steps", [(6, 4), (6, 3)])
def test_chain_golden_matches_jax(num_walks, num_steps):
    n = 32
    indptr, indices = _chain(n)
    seeds = np.arange(n, dtype=np.int32)
    kw = dict(num_walks=num_walks, num_steps=num_steps, seed=3,
              block_size=n)
    jg = JaxCSRGraph(indptr=indptr, indices=indices)
    tg = CSRGraph(indptr=indptr, indices=indices)

    want = jsampler.subg_matrix_device_keys(jg, seeds, **kw)
    got = tsampler.subg_matrix_device_keys(tg, seeds, device="cpu", **kw)
    assert (got.num_walks, got.num_steps) == (num_walks, num_steps - 1)
    for name in ("nodes", "khi", "klo", "sizes"):
        np.testing.assert_array_equal(
            _bits(getattr(got, name).numpy()),
            _bits(getattr(want, name)), err_msg=name)
    # every walk is the path: the set of seed i is i .. i + S'
    np.testing.assert_array_equal(
        got.sizes.numpy(), np.minimum(num_steps, n - seeds))

    want_t, want_u = jsampler.subg_matrix_device(jg, seeds, **kw)
    got_t, got_u = tsampler.subg_matrix_device(tg, seeds, device="cpu",
                                               **kw)
    assert got_u == want_u
    for name in ("nodes", "eidx", "sizes", "enc"):
        g = getattr(got_t, name).numpy()
        w = np.asarray(getattr(want_t, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# (f) evaluate_device

H, NODES, BS, M, NUM_STEPS = 16, 120, 64, 20, 3


def test_joins_take_column_major_edges(monkeypatch):
    """The CLI's training edges are column-major (the concatenation of
    transposed [E, 2] arrays). A batch sliced from them reaches the merge
    as contiguous rows, which the CUDA merge requires, in both joins, and
    joins as the same edges laid out row-major."""
    g = rmat_graph(200, 1200, seed=4)
    seeds = np.arange(g.num_nodes, dtype=np.int32)
    kw = dict(num_walks=6, num_steps=3, seed=1, device="cpu")
    keys = tsampler.subg_matrix_device_keys(g, seeds, **kw)
    table = tsampler.subg_matrix_device(g, seeds, **kw)[0]
    pairs = np.random.default_rng(2).integers(
        0, g.num_nodes, size=(300, 2)).T.astype(np.int32)
    edges = torch.as_tensor(np.concatenate([pairs, pairs], axis=1),
                            dtype=torch.int64)
    batch = edges[:, :256]
    assert not batch.is_contiguous()
    contiguous = []

    def merge(*args):
        contiguous.append(all(a.is_contiguous() for a in args))
        return merge_pairs(*args)

    monkeypatch.setattr(join_ops, "merge_pairs", merge)
    kjoin = join_ops.make_keys_join(keys.num_walks, keys.num_steps)
    krows = (keys.nodes, keys.khi, keys.klo, keys.sizes)
    trows = (table.nodes, table.eidx, table.sizes)
    for got, want in ((kjoin(*krows, batch),
                       kjoin(*krows, batch.contiguous())),
                      (join_ops.gather_join(*trows, batch),
                       join_ops.gather_join(*trows, batch.contiguous()))):
        for x, y in zip(got, want):
            assert (x is None and y is None) or torch.equal(x, y)
    assert len(contiguous) == 4 and all(contiguous)


@pytest.fixture(scope="module")
def scorers():
    """A JAX scorer and the port's over the same JAX-sampled keys and
    weights, float32, dropout 0, the unfused route."""
    g = jax_rmat_graph(NODES, 600, seed=21)
    spgk = jsampler.subg_matrix_device_keys(
        g, np.arange(NODES, dtype=np.int32), num_walks=M,
        num_steps=NUM_STEPS, seed=5, block_size=64)
    jtr = jax_trainer(JaxNet(input_dim=NUM_STEPS, hidden_dim=H,
                             dropout=0.0, fused_hidden=False),
                      spgk, JaxTrainConfig(batch_size=BS))
    e0 = np.zeros((2, BS), np.int32)
    params, _ = jtr.init(jax.random.PRNGKey(0), e0)
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    tspgk = SpGKeys(nodes=c(spgk.nodes), khi=c(spgk.khi), klo=c(spgk.klo),
                    sizes=c(spgk.sizes), num_walks=spgk.num_walks,
                    num_steps=spgk.num_steps)
    net = Net(NUM_STEPS, H, dropout=0.0, fused_hidden=False,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jtr, params, trainer_from_keys(net, tspgk,
                                          TrainConfig(batch_size=BS))


def _inf_edge(metric):
    rng = np.random.default_rng(len(metric))
    out = {}
    for split, npos in (("valid", 70), ("test", 90)):
        pos = rng.integers(0, NODES, size=(2, npos)).astype(np.int32)
        if metric == "MRR":
            k = 7
            neg = np.stack([np.repeat(pos[0], k),
                            rng.integers(0, NODES, npos * k)])
        else:
            neg = rng.integers(0, NODES, size=(2, 3 * npos))
        out[split] = (pos, neg.astype(np.int32))
    return out


class _Fixed:
    """A stand-in trainer whose predict returns given scores."""

    def __init__(self, scores):
        self.scores = scores

    def predict(self, edges):
        return self.scores[np.asarray(edges).tobytes()]


def _values(results):
    if isinstance(results, dict):
        return {k: v for k, v in results.items()}
    return {"": results}


@pytest.mark.parametrize("metric", ["Hits@50", "AUC", "MRR"])
def test_evaluate_device_matches_jax(scorers, metric):
    jtr, params, ttr = scorers
    inf = _inf_edge(metric)
    jscores = {}
    for split, pair in inf.items():
        for e in pair:
            want = np.asarray(jtr.predict(params, e))
            got = ttr.predict(e).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4)
            jscores[e.tobytes()] = torch.tensor(want)
    want, _ = jax_evaluate(jtr, params, inf, metric)
    fed, _ = evaluate_device(_Fixed(jscores), inf, metric)
    own, t_test = evaluate_device(ttr, inf, metric)
    assert t_test >= 0
    assert type(own) is type(want)
    if "Hits" in metric:
        assert sorted(own) == [f"Hits@{k}" for k in (10, 100, 20, 50)]
    flip = 1.0 / min(len(inf["valid"][0][0]), len(inf["test"][0][0]))
    for key, w in _values(want).items():
        f, o = _values(fed)[key], _values(own)[key]
        assert f[0] == o[0] == 0
        for i in (1, 2):
            assert all(type(x[i]) is float for x in (f, o))
            assert abs(f[i] - w[i]) <= 1e-6, (key, i)
            assert abs(o[i] - w[i]) <= flip, (key, i)


# (g) the CLI on the CPU

# the device engine, which `--engine auto` takes on the card
TOY = ["--engine", "device", "--synth_nodes", "2000", "--synth_edges",
       "12000", "--num_walks",
       "10", "--num_steps", "3", "--epochs", "2", "--eval_steps", "1",
       "--batch_size", "512"]


@pytest.mark.parametrize("dataset,aggrs,runs", [
    ("synth-collab", "mean", 2), ("synth-collab", "attn", 1),
    ("synth-collab", "lstm", 1), ("synth-cites", "mean", 1),
    ("synth-vessel", "mean", 1)])
def test_run_experiment_on_the_cpu(tmp_path, dataset, aggrs, runs):
    argv = ["--dataset", dataset, "--aggrs", aggrs, "--runs", str(runs),
            "--log_dir", str(tmp_path), *TOY]
    if dataset == "synth-cites":
        argv += ["--metric", "MRR"]
    cfg = _config(tconfig, argv)
    out = cli.run_experiment(cfg, device="cpu")
    best = out["best"]
    assert len(best) == runs
    for pair in best:
        assert len(pair) == 2
        assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in pair)
    (log_file,) = (tmp_path / dataset).glob("*.log")
    parsed = _summarizer().parse(str(log_file))
    key = cfg.metric if "Hits" in cfg.metric else "MRR"
    assert len(parsed[key]) == runs
    for evals in parsed[key]:
        assert evals.shape == (2, 2)     # an eval after each epoch
    text = log_file.read_text()
    assert "Run: 01, Epoch: 01, Loss:" in text
    assert "phase train_epoch" in text and "phase eval" in text
    assert "phase load" in text and "phase ingest.csr" in text
    assert ("All runs" in text) == (runs > 1)


def test_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SUREL_PLATFORM", "cpu")
    cli.main(["--dataset", "synth-collab", "--log_dir", str(tmp_path),
              *TOY])
    best = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(best) == 1 and len(best[0]) == 2


def test_main_without_a_device_raises(monkeypatch):
    monkeypatch.delenv("SUREL_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SUREL_PLATFORM=cpu"):
        cli.main(["--dataset", "synth-collab", *TOY])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_experiment(_config(tconfig, ["--dataset", "synth-collab"]))


@pytest.mark.parametrize("extra", [["--dataset", "ogbl-collab"]],
                         ids=["ogbl"])
def test_unported_options_raise(tmp_path, monkeypatch, extra):
    """Without the `ogb` package an `ogbl-*` dataset raises ImportError in
    both CLIs (the import in from_ogb)."""
    monkeypatch.setitem(sys.modules, "ogb", None)
    cfg = _config(tconfig, ["--dataset", "synth-collab", "--log_dir",
                            str(tmp_path), *extra])
    with pytest.raises(ImportError):
        cli.run_experiment(cfg, device="cpu")
    with pytest.raises(ImportError):
        jcli.load_raw(_config(jconfig, ["--dataset", "ogbl-collab"]))


class _StubLinkDataset:
    """`ogb.linkproppred.PygLinkPropPredDataset` as from_ogb reads it: one
    graph (a dict of torch tensors) and the edge split."""

    graph: dict = {}
    split: dict = {}

    def __init__(self, name):
        self.name = name

    def __getitem__(self, i):
        assert i == 0
        return self.graph

    def get_edge_split(self):
        return self.split


def _stub_ogb(monkeypatch, graph, split):
    ogb = types.ModuleType("ogb")
    lp = types.ModuleType("ogb.linkproppred")
    lp.PygLinkPropPredDataset = type("PygLinkPropPredDataset",
                                     (_StubLinkDataset,),
                                     dict(graph=graph, split=split))
    ogb.linkproppred = lp
    monkeypatch.setitem(sys.modules, "ogb", ogb)
    monkeypatch.setitem(sys.modules, "ogb.linkproppred", lp)


@pytest.mark.parametrize("x,weight,directed", [
    (True, True, False), (False, False, False), (False, True, True)])
def test_from_ogb_matches_jax(monkeypatch, x, weight, directed):
    g = torch.Generator().manual_seed(4)
    edge_index = torch.randint(0, 40, (2, 90), generator=g)
    graph = {"edge_index": edge_index}
    if x:
        graph["x"] = torch.randn(45, 3, generator=g)
    if weight:
        graph["edge_weight"] = torch.rand(90, 1, generator=g)
    if directed:
        split = {s: {"source_node": torch.randint(0, 40, (n,), generator=g),
                     "target_node": torch.randint(0, 40, (n,), generator=g)}
                 for s, n in (("train", 30), ("valid", 6), ("test", 6))}
        for s in ("valid", "test"):
            split[s]["target_node_neg"] = torch.randint(
                0, 40, (6, 5), generator=g)
    else:
        split = {s: {"edge": torch.randint(0, 40, (n, 2), generator=g)}
                 for s, n in (("train", 30), ("valid", 6), ("test", 6))}
        for s in ("valid", "test"):
            split[s]["edge_neg"] = torch.randint(0, 40, (8, 2), generator=g)
    _stub_ogb(monkeypatch, graph, split)
    got, want = tds.from_ogb("ogbl-stub"), jds.from_ogb("ogbl-stub")
    routed = cli.load_raw(_config(tconfig, ["--dataset", "ogbl-collab"]))
    for raw in (got, routed):
        assert raw.num_nodes == want.num_nodes == (45 if x else 40)
        assert raw.directed == want.directed == directed
        for k in ("edge_index", "x", "edge_weight"):
            a, b = getattr(raw, k), getattr(want, k)
            assert (a is None) == (b is None) == (
                {"x": not x, "edge_weight": not weight}.get(k, False)), k
            if b is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        assert sorted(raw.split_edge) == sorted(want.split_edge)
        for s, d in want.split_edge.items():
            assert sorted(raw.split_edge[s]) == sorted(d)
            for k, v in d.items():
                np.testing.assert_array_equal(raw.split_edge[s][k], v)
