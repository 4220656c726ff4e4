"""PyTorch port, MAG relation prediction, against the JAX package:

- `synthetic_hetero_data` array for array, for both relations;
- `DEHDataset.process` (positives, negatives, the three CSR graphs)
  exactly, from the same seed, with the same draws left in the
  generator;
- `from_npz` and `from_pickle` on the same files (the pickle written by
  `torch.save` in the reference's layout: `split_edge`, `num_nodes_dict`,
  `edge_index` keyed by (src, rel, dst) tuples, tensors), also through
  the CLI's `load_hetero` from a working directory;
- `run_experiment` on `synth-mag` and on `npz:<tmp>/mag_cite.npz`, on
  both engines: finite MRRs, and the valid and test edges the evaluation
  gets equal to JAX's `get_pos_neg_edges` on the JAX CLI's data prep;
- the higher-order CLI's reference pickle (`./dataset/sgrl/<name>.pl`)
  read as the JAX CLI reads it, and a toy run over it.
"""

import argparse
import math

import numpy as np
import pytest
import torch

from surel_plus_tpu.cli import main as jcli
from surel_plus_tpu.cli import main_horder as jhorder
from surel_plus_tpu.graph import datasets as jds
from surel_plus_tpu.graph.splits import get_pos_neg_edges as jax_splits
from surel_plus_tpu.utils import config as jconfig
from surel_plus_tpu.utils.seeding import set_random_seed as jax_seed
from surel_plus_tpu_torch.cli import main as cli
from surel_plus_tpu_torch.cli import main_horder
from surel_plus_tpu_torch.graph import datasets as tds
from surel_plus_tpu_torch.utils import config as tconfig
from surel_plus_tpu_torch.utils.seeding import set_random_seed
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOY = ["--num_walks", "8", "--num_steps", "3", "--epochs", "2",
       "--eval_steps", "1", "--batch_size", "256", "--hidden_channels",
       "16", "--k", "5"]


def _config(pkg, argv):
    return pkg.apply_dataset_overrides(
        pkg.config_from_args(_parser(pkg).parse_args(argv)))


def _assert_same_dataset(got, want):
    np.testing.assert_array_equal(got.train_edge, want.train_edge)
    np.testing.assert_array_equal(got.obsrv_edge, want.obsrv_edge)
    assert got.num_nodes == want.num_nodes
    assert got.node_type == want.node_type
    assert got.num_feature == want.num_feature
    assert (got.mask_ratio, got.k) == (want.mask_ratio, want.k)
    assert sorted(got.split_edge) == sorted(want.split_edge)
    for split, d in want.split_edge.items():
        assert sorted(got.split_edge[split]) == sorted(d)
        for key, val in d.items():
            np.testing.assert_array_equal(got.split_edge[split][key], val)


def _assert_same_graphs(got, want):
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    for name, g in got.items():
        np.testing.assert_array_equal(g.indptr, want[name].indptr)
        np.testing.assert_array_equal(g.indices, want[name].indices)
        np.testing.assert_array_equal(g.data, want[name].data)


@pytest.mark.parametrize("relation", ["cite", "write"])
def test_synthetic_hetero_data_matches_jax(relation):
    kw = dict(num_authors=120, num_papers=200, num_writes=700,
              num_cites=900, relation=relation, seed=4, neg_per_query=7,
              mask_ratio=0.1, k=3)
    _assert_same_dataset(tds.synthetic_hetero_data(**kw),
                         jds.synthetic_hetero_data(**kw))


@pytest.mark.parametrize("relation", ["cite", "write"])
def test_process_matches_jax(relation):
    kw = dict(relation=relation, seed=2, mask_ratio=0.2, k=4)
    got = tds.synthetic_hetero_data(rng=np.random.default_rng(9), **kw)
    want = jds.synthetic_hetero_data(rng=np.random.default_rng(9), **kw)
    _assert_same_graphs(got.process(), want.process())
    assert got.num_pos == want.num_pos > 0
    np.testing.assert_array_equal(got.pos_edge, want.pos_edge)
    np.testing.assert_array_equal(got.neg_edge, want.neg_edge)
    assert len(got.neg_edge) == min(got.num_pos * 4, got.len_train)
    # the generators were left in the same state
    assert got.rng.integers(1 << 30) == want.rng.integers(1 << 30)


def _write_pickle(path, ds, relation):
    """The reference's pickle layout of `ds` (relation 'cite' reads the
    writes as the observed edges, 'write' the cites)."""
    t = lambda x: torch.as_tensor(np.asarray(x))
    rel = (("author", "writes", "paper") if relation == "cite"
           else ("paper", "cites", "paper"))
    other = (("paper", "cites", "paper") if relation == "cite"
             else ("author", "writes", "paper"))
    torch.save({
        "split_edge": {split: {k: t(v) for k, v in d.items()}
                       for split, d in ds.split_edge.items()},
        "num_nodes_dict": {"author": 120, "paper": ds.num_nodes - 120},
        "edge_index": {rel: t(ds.obsrv_edge.T),
                       other: t(ds.train_edge[:5].T)},
    }, path)


@pytest.mark.parametrize("relation", ["cite", "write"])
def test_from_pickle_matches_jax(tmp_path, monkeypatch, relation):
    src = tds.synthetic_hetero_data(num_authors=120, num_papers=200,
                                    relation=relation, seed=6)
    (tmp_path / "dataset" / "sgrl").mkdir(parents=True)
    path = tmp_path / "dataset" / "sgrl" / f"mag_{relation}.pl"
    _write_pickle(path, src, relation)
    got = tds.DEHDataset.from_pickle(str(path), relation, k=3)
    want = jds.DEHDataset.from_pickle(str(path), relation, k=3)
    _assert_same_dataset(got, want)
    np.testing.assert_array_equal(got.obsrv_edge, src.obsrv_edge)
    assert got.node_type == ["author", "paper"]
    # the CLI reads ./dataset/sgrl/{dataset}_{relation}.pl
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "mag", "--relation", relation, "--k", "3"]
    cfg, jcfg = _config(tconfig, argv), _config(jconfig, argv)
    _assert_same_dataset(cli.load_hetero(cfg, set_random_seed(cfg.seed)),
                         jcli.load_hetero(jcfg, jax_seed(jcfg.seed)))


def test_from_npz_matches_jax(tmp_path):
    src = tds.synthetic_hetero_data(seed=8, neg_per_query=6)
    path = str(tmp_path / "mag_cite.npz")
    src.to_npz(path)
    got = tds.DEHDataset.from_npz(path, k=2)
    _assert_same_dataset(got, jds.DEHDataset.from_npz(path, k=2))
    _assert_same_dataset(got, tds.DEHDataset(
        src.train_edge, src.obsrv_edge, src.split_edge, src.num_nodes,
        node_types=src.node_type, k=2))


def _jax_inf_edge(argv):
    """The JAX CLI's data prep up to the valid and test edges."""
    cfg = _config(jconfig, argv)
    rng = jax_seed(cfg.seed)
    ds = jcli.load_hetero(cfg, rng)
    ds.process()
    args = (ds.split_edge, ds.train_edge.T, ds.num_nodes)
    return {"valid": jax_splits("valid", *args, percent=cfg.valid_perc,
                                rng=rng),
            "test": jax_splits("test", *args, rng=rng)}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("dataset", ["synth-mag", "npz"])
def test_run_experiment_on_mag(tmp_path, monkeypatch, dataset, engine):
    if dataset == "npz":
        path = tmp_path / "mag_cite.npz"
        tds.synthetic_hetero_data(seed=3, neg_per_query=10).to_npz(path)
        dataset = f"npz:{path}"
    argv = ["--dataset", dataset, "--engine", engine, "--log_dir",
            str(tmp_path / "logs"), "--valid_perc", "60", *TOY]
    fed = []
    name = "evaluate_device" if engine == "device" else "evaluate"
    real = getattr(cli, name)

    def spy(scorer, inf_edge, metric):
        fed.append({split: tuple(np.asarray(torch.as_tensor(e).cpu())
                                 for e in pair)
                    for split, pair in inf_edge.items()})
        return real(scorer, inf_edge, metric)

    monkeypatch.setattr(cli, name, spy)
    cfg = _config(tconfig, argv)
    assert cfg.metric == "MRR"
    out = cli.run_experiment(cfg, device="cpu")
    (best,) = out["best"]
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in best)
    evals = out["results"].results[0]
    assert len(evals) == 2
    assert all(math.isfinite(x) for e in evals for x in e[1:])
    want = _jax_inf_edge(argv)
    assert len(fed) == 2
    for got in fed:
        for split in ("valid", "test"):
            for g, w in zip(got[split], want[split]):
                np.testing.assert_array_equal(g, w)


def test_horder_reads_the_reference_pickle(tmp_path, monkeypatch):
    """main_horder's `./dataset/sgrl/<name>.pl` branch: the same dataset
    as the JAX CLI's from one torch pickle, and a toy run over it."""
    src = tds.synthetic_hyper_data(num_nodes=150, num_triplets=500, seed=2)
    t = lambda x: torch.as_tensor(np.asarray(x))
    (tmp_path / "dataset" / "sgrl").mkdir(parents=True)
    torch.save({"edge_index": t(src.obsrv_edge),
                "triplets": {s: {k: t(v) for k, v in d.items()}
                             for s, d in src.split_edge.items()}},
               tmp_path / "dataset" / "sgrl" / "tags-toy.pl")
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "tags-toy", "--log_dir", str(tmp_path / "logs"),
            "--valid_perc", "50", "--engine", "device", *TOY]
    parse = lambda pkg: pkg.config_from_args(_parser(pkg).parse_args(argv))
    got = main_horder.load_hyper(parse(tconfig))
    want = jhorder.load_hyper(parse(jconfig))
    np.testing.assert_array_equal(got.obsrv_edge, want.obsrv_edge)
    assert (got.num_nodes, got.k) == (want.num_nodes, want.k) == (
        src.num_nodes, 5)
    for split, d in want.split_edge.items():
        for key, val in d.items():
            np.testing.assert_array_equal(got.split_edge[split][key], val)
    out = main_horder.run_experiment(parse(tconfig), device="cpu")
    assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in out["best"][0])


def _parser(pkg):
    parser = argparse.ArgumentParser()
    pkg.add_config_args(parser)
    return parser
