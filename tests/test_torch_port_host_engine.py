"""PyTorch port, the host engine and balanced batching: the host metrics
(`ops/metrics.py`), `LinkPredictor` and `ScalarLinkPredictor` epochs and
`evaluate` (`train/loop.py`, `train/scalar.py`), the device engine's
width-balanced batching (`partition_by_width`, `fit_balanced`,
`predict_balanced`) and the CLIs' new branches (`--engine host`,
`--sencoder`, `--balance_widths`), each against the JAX package.

Tolerances, with their reasons:
- the metrics and the partition: equal (the same numpy code);
- a host epoch from JAX's weights, the same numpy seed and dropout 0:
  loss rtol 1e-5, AUC atol 1e-6, parameters rtol 1e-4, atol 1e-5 (the
  attention gate's bias, whose gradient is 0 up to rounding, 2 lr a
  step), as tests/test_torch_port_train.py holds the device trainer;
- `evaluate` from JAX's weights: within 1e-6 (float32 scores summed in
  other orders, then the same host reductions);
- `predict_balanced` against `predict`: rtol 0, atol 1e-6 (each query's
  rows hold the same slots at either width, but the set sums reduce
  vectors of another length, in another order: the mean Net's scores
  differ in the last bits on the CPU);
- `fit_balanced` with JAX's per-class permutations: as a host epoch;
  one class at the bucket width against `fit` with the same
  permutations: equal;
- the CLI's scalar sets and PPR cache against JAX's: exact.
"""

import argparse
import math

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from surel_plus_tpu.cli import main as jax_cli
from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import HONet as JaxHONet
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import encoders as jax_enc
from surel_plus_tpu.ops import metrics as jax_metrics
from surel_plus_tpu.ops import ppr as jax_ppr
from surel_plus_tpu.ops.join import hgather_join as jax_hgather_join
from surel_plus_tpu.ops.sampler import sample_gsets_device as jax_gsets
from surel_plus_tpu.ops.sampler import subg_matrix as jax_subg_matrix
from surel_plus_tpu.train import LinkPredictor as JaxLinkPredictor
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train import evaluate as jax_evaluate
from surel_plus_tpu.train.device import DeviceTrainer as JaxDeviceTrainer
from surel_plus_tpu.train.scalar import (
    ScalarLinkPredictor as JaxScalarLinkPredictor,
)
from surel_plus_tpu.utils import config as jconfig
from surel_plus_tpu_torch.cli import main as cli
from surel_plus_tpu_torch.cli import main_horder as hcli
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.models import HONet, Net
from surel_plus_tpu_torch.ops import encoders, metrics, prng
from surel_plus_tpu_torch.ops.join import hgather_join
from surel_plus_tpu_torch.spg import SpG, SpGDevice
from surel_plus_tpu_torch.train import LinkPredictor, TrainConfig, evaluate
from surel_plus_tpu_torch.train.device import DeviceTrainer
from surel_plus_tpu_torch.train.scalar import ScalarLinkPredictor
from surel_plus_tpu_torch.utils import config as tconfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, H = 60, 16
AGGRS = ("attn", "lstm", "mean")
GATE_BIAS = "aggr.gate_nn.bias"   # gradient 0 up to rounding
BS, E, LR = 16, 45, 1e-2          # E % BS != 0


def _c(x):
    return torch.as_tensor(np.array(x))


def _flat(p):
    return params_from_flax(jax.tree.map(np.asarray, p))


def _check_params(net, want, steps):
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        atol = 2 * LR * steps if k == GATE_BIAS else 1e-5
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------ metrics
def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pos = np.round(rng.random(50), 2)               # rounded: many ties
    neg = np.round(rng.random(400), 2)
    neg2 = np.round(rng.random((50, 8)), 2)
    labels = (rng.random(450) < 0.3).astype(np.float32)
    scores = np.concatenate([pos, neg])
    for k in (1, 10, 100, 500):
        assert metrics.hits_at_k(pos, neg, k) == jax_metrics.hits_at_k(
            pos, neg, k)
    assert metrics.mrr(pos, neg2) == jax_metrics.mrr(pos, neg2)
    np.testing.assert_array_equal(metrics.mrr_list(pos, neg2),
                                  jax_metrics.mrr_list(pos, neg2))
    assert metrics.roc_auc(labels, scores) == jax_metrics.roc_auc(labels,
                                                                  scores)
    assert math.isnan(metrics.roc_auc(np.ones(4), np.arange(4)))
    assert metrics.evaluate_hits(pos, neg) == jax_metrics.evaluate_hits(
        pos, neg)
    for name in ("ogbl-citation2", "ogbl-vessel", "ogbl-collab",
                 "tags-math", "synth-mag"):
        te, je = metrics.evaluator_for(name), jax_metrics.evaluator_for(name)
        assert (te.name, te.metric, te.K) == (je.name, je.metric, je.K)
        te.K = je.K = 20
        for negs in (neg, neg2):
            want = je.eval({"y_pred_pos": pos, "y_pred_neg": negs})
            got = te.eval({"y_pred_pos": pos, "y_pred_neg": negs})
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------ host engine
@pytest.fixture(scope="module")
def host_sets():
    """JAX's host encoding-table sets (`subg_matrix`) of a small rmat
    graph, the port's SpG with the same arrays, and the PPR scalar sets
    (JAX's and the port's)."""
    g = jax_rmat_graph(N, 300, seed=31)
    seeds = np.arange(N, dtype=np.int32)
    jspg = jax_subg_matrix(g, seeds, num_walks=16, num_steps=4, seed=3)
    tspg = SpG(nodes=jspg.nodes, eidx=jspg.eidx, sizes=jspg.sizes,
               enc=jspg.enc, seeds=jspg.seeds, num_walks=jspg.num_walks,
               num_steps=jspg.num_steps)
    x = jax_ppr.topk_ppr_matrix(g, 0.5, 1e-4, seeds, 12,
                                normalization="sym")
    x, _ = jax_enc.encoding(x.tocsr(), g.to_scipy(), "PPR")
    jss = jax_enc.scalar_spg_from_csr(x.tocsr())
    tss = encoders.ScalarSpG(nodes=jss.nodes, values=jss.values,
                             sizes=jss.sizes, seeds=jss.seeds)
    return jspg, tspg, jss, tss


def _host_case(host_sets, kind, aggrs):
    """(JAX predictor, the port's from JAX's initial weights, edges,
    labels) of one host-engine case: "table" (LP sets, gather_join),
    "scalar" (PPR sets) or "honet" (LP sets, hyperedges)."""
    jspg, tspg, jss, tss = host_sets
    rng = np.random.default_rng(33)
    q = 3 if kind == "honet" else 2
    edges = rng.integers(0, N, size=(q, E)).astype(np.int32)
    labels = (rng.random(E) < 0.5).astype(np.float32)
    jcfg = JaxTrainConfig(batch_size=BS, lr=LR)
    tcfg = TrainConfig(batch_size=BS, lr=LR)
    if kind == "honet":
        jp = JaxLinkPredictor(JaxHONet(input_dim=4, hidden_dim=H,
                                       dropout=0.0), jspg, jcfg,
                              join_fn=jax_hgather_join)
        net = HONet(4, H, dropout=0.0, key=prng.prng_key(0), device="cpu")
    elif kind == "table":
        jp = JaxLinkPredictor(JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs,
                                     dropout=0.0), jspg, jcfg)
        net = Net(4, H, aggrs=aggrs, dropout=0.0,
                  key=prng.prng_key(0), device="cpu")
    else:
        jp = JaxScalarLinkPredictor(JaxNet(input_dim=1, hidden_dim=H,
                                           aggrs=aggrs, dropout=0.0),
                                    jss, jcfg)
        net = Net(1, H, aggrs=aggrs, dropout=0.0,
                  key=prng.prng_key(0), device="cpu")
    params, opt_state = jp.init(jax.random.PRNGKey(2), edges[:, :BS])
    net.load_state_dict(_flat(params))
    if kind == "scalar":
        tp = ScalarLinkPredictor(net, tss, tcfg, device="cpu")
    elif kind == "honet":
        tp = LinkPredictor(net, tspg, tcfg, join_fn=hgather_join,
                           device="cpu")
    else:
        tp = LinkPredictor(net, tspg, tcfg, device="cpu")
    return jp, (params, opt_state), tp, edges, labels


# the host step is the same for every model (the aggregators' routes are
# held in the Net's and the device trainer's tests): the table and scalar
# joins under the mean Net, and HONet over the hyperedge table join
HOST_CASES = [("table", "mean"), ("scalar", "mean"), ("honet", "mean")]


@pytest.mark.parametrize("kind,aggrs", HOST_CASES,
                         ids=[f"{k}-{a}" for k, a in HOST_CASES])
def test_host_epoch_matches_jax(host_sets, kind, aggrs):
    """Two host epochs (permutations from one numpy seed) from JAX's
    initial weights: the losses, the exact AUCs and the parameters."""
    jp, (params, opt_state), tp, edges, labels = _host_case(host_sets, kind,
                                                            aggrs)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        params, opt_state, jloss, jauc = jp.train_epoch(
            params, opt_state, edges, labels, jrng, key)
        tloss, tauc = tp.train_epoch(edges, labels, trng,
                                     prng.as_key(key))
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        np.testing.assert_allclose(tauc, jauc, rtol=0, atol=1e-6)
    assert isinstance(tloss, float) and isinstance(tauc, float)
    np.testing.assert_array_equal(trng.random(3), jrng.random(3))
    _check_params(tp.model, _flat(params), 2 * -(-E // BS))
    got = tp.predict(edges)
    assert got.dtype == np.float32 and got.shape == (E,)
    np.testing.assert_allclose(got, np.asarray(jp.predict(params, edges)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["Hits@20", "AUC", "MRR"])
def test_evaluate_matches_jax(host_sets, metric):
    jp, (params, _), tp, _, _ = _host_case(host_sets, "table", "mean")
    rng = np.random.default_rng(34)
    pos = rng.integers(0, N, size=(2, 30)).astype(np.int32)
    neg = rng.integers(0, N, size=(2, 30 * 5)).astype(np.int32)
    inf_edge = {"valid": (pos, neg), "test": (pos[:, ::-1].copy(), neg)}
    want, _ = jax_evaluate(jp, params, inf_edge, metric)
    got, seconds = evaluate(tp, inf_edge, metric)
    assert seconds >= 0
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        want, got = list(want.values()), list(got.values())
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ balanced
@pytest.fixture(scope="module")
def table_sets():
    g = jax_rmat_graph(N, 300, seed=35)
    jdev, _ = jax_gsets(g, np.arange(N, dtype=np.int32), num_walks=16,
                        num_steps=3, seed=5, block_size=32)
    tdev = SpGDevice(nodes=_c(jdev.nodes), eidx=_c(jdev.eidx),
                     sizes=_c(jdev.sizes), enc=_c(jdev.enc))
    edges = np.random.default_rng(36).integers(0, N, size=(2, 3 * E)
                                               ).astype(np.int32)
    sizes = np.asarray(jdev.sizes)[edges].max(axis=0)
    # classes at the lower quartile, the median and the bucket
    bucket = jdev.nodes.shape[1]
    classes = tuple(int(np.percentile(sizes, p)) for p in (25, 50)) + (
        bucket,)
    return jdev, tdev, edges, classes


def test_partition_by_width_matches_jax(table_sets):
    jdev, tdev, edges, classes = table_sets
    jtr = JaxDeviceTrainer(JaxNet(input_dim=4, hidden_dim=H), jdev,
                           JaxTrainConfig(batch_size=BS))
    tr = DeviceTrainer(Net(4, H, key=prng.prng_key(0), device="cpu"), tdev,
                       TrainConfig(batch_size=BS))
    want = jtr.partition_by_width(edges, classes)
    for got in (tr.partition_by_width(edges, classes),
                tr.partition_by_width(torch.as_tensor(edges), classes)):
        assert [w for w, _ in got] == [w for w, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert all(len(sel) for _, sel in got)
    for bad in (classes[::-1], classes[:1]):
        with pytest.raises(ValueError):
            tr.partition_by_width(edges, bad)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_predict_balanced_equals_predict(table_sets, aggrs):
    _, tdev, edges, classes = table_sets
    net = Net(4, H, aggrs=aggrs, device="cpu",
              key=prng.prng_key(1))
    tr = DeviceTrainer(net, tdev, TrainConfig(batch_size=BS))
    want = tr.predict(edges)
    got = tr.predict_balanced(edges, classes)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("aggrs", ["lstm", "mean"])
def test_fit_balanced_matches_jax(table_sets, aggrs):
    """JAX's fit_balanced for 2 epochs against the port's from JAX's key,
    so that the port draws JAX's per-class permutations
    (riffle_permutation(fold_in(epoch key, class))), from JAX's initial
    weights, dropout 0; the lstm on its fused route (JAX's folded scan,
    the port's K5 pair in plain versions)."""
    jdev, tdev, edges, classes = table_sets
    fused = True if aggrs == "lstm" else None
    labels = (np.random.default_rng(37).random(edges.shape[1]) < 0.5
              ).astype(np.float32)
    jtr = JaxDeviceTrainer(JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs,
                                  dropout=0.0, fused_hidden=fused), jdev,
                           JaxTrainConfig(batch_size=BS, lr=LR))
    params0, opt_state = jtr.init(jax.random.PRNGKey(0), edges[:, :BS])
    key = jax.random.PRNGKey(8)
    params, _, losses, aucs, groups = jtr.fit_balanced(
        params0, opt_state, edges, labels, key, 2, classes)
    net = Net(4, H, aggrs=aggrs, dropout=0.0, fused_hidden=fused,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(_flat(params0))
    tr = DeviceTrainer(net, tdev, TrainConfig(batch_size=BS, lr=LR))
    got_losses, got_aucs, got_groups = tr.fit_balanced(
        edges, labels, 2, prng.as_key(key), classes)
    assert [len(s) for _, s in got_groups] == [len(s) for _, s in groups]
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=1e-5)
    np.testing.assert_allclose(got_aucs.numpy(), np.asarray(aucs),
                               atol=1e-6)
    steps = 2 * sum(-(-len(s) // BS) for _, s in groups)
    _check_params(net, _flat(params), steps)


def test_fit_balanced_one_class_equals_fit(table_sets):
    _, tdev, edges, _ = table_sets
    labels = torch.as_tensor((np.random.default_rng(38).random(
        edges.shape[1]) < 0.5).astype(np.float32))
    gen = torch.Generator().manual_seed(9)
    nsteps = -(-edges.shape[1] // BS)
    perms = [torch.randperm(nsteps * BS, generator=gen).reshape(nsteps, BS)
             for _ in range(2)]
    out = []
    for balanced in (False, True):
        net = Net(4, H, dropout=0.0, device="cpu",
                  key=prng.prng_key(2))
        tr = DeviceTrainer(net, tdev, TrainConfig(batch_size=BS, lr=LR))
        if balanced:
            res = tr.fit_balanced(edges, labels, 2, prng.prng_key(0),
                                  (tdev.nodes.shape[1],),
                                  perms=[[p] for p in perms])[:2]
        else:
            res = tr.fit(edges, labels, 2, prng.prng_key(0), perms=perms)
        out.append((res, net.state_dict()))
    (fit_res, fit_state), (bal_res, bal_state) = out
    for a, b in zip(fit_res, bal_res):
        assert torch.equal(a, b)
    for k, v in fit_state.items():
        assert torch.equal(bal_state[k], v), k


# ------------------------------------------------------------ the CLIs
def _config(pkg, argv):
    parser = argparse.ArgumentParser()
    pkg.add_config_args(parser)
    return pkg.apply_dataset_overrides(
        pkg.config_from_args(parser.parse_args(argv)))


@pytest.mark.parametrize("sencoder", ["PPR", "SPD", "DEG"])
def test_scalar_pipeline_matches_jax(tmp_path, monkeypatch, sencoder):
    """The CLI's scalar sets of a graph and the inference graph's PPR
    cache file (its name and matrix) against JAX's `_scalar_pipeline`;
    `--load_ppr` reads the file back."""
    monkeypatch.chdir(tmp_path)
    g = rmat_graph(N, 300, seed=39)
    jg = jax_rmat_graph(N, 300, seed=39)
    argv = ["--dataset", "synth-collab", "--sencoder", sencoder,
            "--topk", "12", "--save_ppr"]
    cfg, jcfg = _config(tconfig, argv), _config(jconfig, argv)
    name = f"synth-collab_z_{cfg.alpha}_{cfg.topk}_{cfg.eps}.npz"
    want = jax_cli._scalar_pipeline(jcfg, jg, None, save_load=True)
    (tmp_path / name).rename(tmp_path / "jax.npz")
    got = cli._scalar_pipeline(cfg, g, None, save_load=True)
    for f in ("nodes", "values", "sizes", "seeds"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    a, b = sp.load_npz(tmp_path / name), sp.load_npz(tmp_path / "jax.npz")
    assert (a != b).nnz == 0 and a.dtype == b.dtype
    cfg.load_ppr = True
    again = cli._scalar_pipeline(cfg, g, None, save_load=True)
    np.testing.assert_array_equal(again.values, got.values)


TOY = ["--dataset", "synth-collab", "--synth_nodes", "600", "--synth_edges",
       "3000", "--num_walks", "10", "--num_steps", "3", "--epochs", "2",
       "--eval_steps", "1", "--batch_size", "256", "--topk", "16"]
# the LP rows; the scalar encoders' rows: tests/test_torch_port_scalar.py
CLI_CASES = {"host_lp": ["--engine", "host"],
             "balanced": ["--engine", "device", "--balance_widths", "8,16"]}


def run_toy_cli(tmp_path, extra):
    """`run_experiment` on the CPU at a toy size with `extra` flags; checks
    the best pair, the log and the engine; returns its output."""
    cfg = _config(tconfig, [*TOY, "--log_dir", str(tmp_path), *extra])
    out = cli.run_experiment(cfg, device="cpu")
    (best,) = out["best"]
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in best)
    text = next((tmp_path / "synth-collab").glob("*.log")).read_text()
    assert "Run: 01, Epoch: 01, Loss:" in text
    assert ("balanced-width batching: classes" in text) == (
        "--balance_widths" in extra)
    if cfg.engine == "host":
        assert isinstance(out["trainer"], LinkPredictor)
        assert out["trainer"].model.dtype == torch.float32
    else:
        assert isinstance(out["trainer"], DeviceTrainer)
    return out


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_new_cli_branches_on_the_cpu(tmp_path, case):
    run_toy_cli(tmp_path, CLI_CASES[case])


def test_horder_host_engine_on_the_cpu(tmp_path):
    cfg = _config(tconfig, [
        "--dataset", "synth-tags", "--synth_nodes", "300", "--synth_edges",
        "400", "--num_walks", "10", "--num_steps", "3", "--epochs", "2",
        "--eval_steps", "1", "--batch_size", "256", "--engine", "host",
        "--log_dir", str(tmp_path)])
    out = hcli.run_experiment(cfg, device="cpu")
    (best,) = out["best"]
    assert all(math.isfinite(x) and 0.0 < x <= 1.0 for x in best)
    assert isinstance(out["trainer"], LinkPredictor)
    assert out["edges"].shape[0] == 3


@pytest.mark.parametrize("horder", [False, True], ids=["main", "horder"])
def test_auto_engine_on_the_cpu_is_the_host_engine(tmp_path, horder):
    """`--engine auto` (the default) on the CPU takes the host engine in
    both CLIs, as the JAX package's CLIs do on a CPU backend; the device
    engine is `--engine device` there (and auto's choice on the card)."""
    argv = ["--synth_nodes", "300", "--synth_edges", "1200", "--num_walks",
            "8", "--num_steps", "3", "--epochs", "1", "--eval_steps", "1",
            "--batch_size", "256", "--log_dir", str(tmp_path)]
    pkg = hcli if horder else cli
    cfg = _config(tconfig, ["--dataset", "synth-tags" if horder
                            else "synth-collab", *argv])
    assert cfg.engine == "auto"
    assert not cli.device_engine("auto", torch.device("cpu"))
    assert cli.device_engine("auto", torch.device("cuda"))
    assert cli.device_engine("device", torch.device("cpu"))
    out = pkg.run_experiment(cfg, device="cpu")
    assert isinstance(out["trainer"], LinkPredictor)
    if not horder:
        assert out["trainer"].model.dtype == torch.float32


def test_width_classes_complete_the_bucket():
    cfg = _config(tconfig, ["--balance_widths", "64,16"])
    assert cli.width_classes(cfg, 101) == (16, 64, 101)
    assert cli.width_classes(cfg, 64) == (16, 64)


def test_unknown_engine_and_sencoder_raise(tmp_path):
    for extra in (["--engine", "tpu"], ["--sencoder", "XYZ"]):
        cfg = _config(tconfig, [*TOY, "--log_dir", str(tmp_path), *extra])
        with pytest.raises(ValueError):
            cli.run_experiment(cfg, device="cpu")
