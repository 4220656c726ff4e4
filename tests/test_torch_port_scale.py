"""PyTorch port, the large-graph path (`surel_plus_tpu_torch/cli/
scale_demo.py`, `graph/synthetic.py:rmat_pairs_chunked`) and the walk
graph's device words, held to the JAX package.

- The chunked R-MAT pairs equal `scripts/scale_demo.py:rmat_pairs_chunked`
  array for array. The script's top level reads `sys.argv` and sets JAX's
  config, so the test compiles that one function from the script's `ast`.
- The walk graph on the device is the JAX package's int32 words: indptr
  and indices (`CSRGraph.device`), the first-hop shuffle
  (`shuffled_indices_for`) and the edge tables (`build_walk_tables`),
  exactly; the chunked table build equals a one-chunk build. A graph of
  2^31 or more directed edges raises on upload (checked on a zero-stride
  array: nothing that large is allocated).
- A toy `device` run on the CPU against the same sequence of JAX package
  calls: the CSR and both samplings' sets exactly, the fits' losses in
  fp32 (dropout 0.1, JAX's masks) at rtol 1e-5, the fit tolerance of
  tests/test_torch_port_train.py.
- A 2-rank `partitioned` run on the CPU reports the Emax and byte counts
  of JAX's `partition_csr` at 2 shards.
- Asked for the card where there is none, the entry points raise.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.csr import csr_from_edges as jax_csr_from_edges
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import walk as jwalk
from surel_plus_tpu.ops.sampler import device_graph as jax_device_graph
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys as jax_sample
from surel_plus_tpu.ops.sampler import shuffled_indices_for as jax_shuffled
from surel_plus_tpu.parallel import partition as jpart
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.cli import scale_demo
from surel_plus_tpu_torch.graph.csr import (
    MAX_DEVICE_EDGES,
    CSRGraph,
    check_int32_edges,
    csr_from_edges,
)
from surel_plus_tpu_torch.graph.synthetic import rmat_pairs_chunked
from surel_plus_tpu_torch.ops import walk as twalk
from surel_plus_tpu_torch.ops.sampler import (
    cached_graph_bytes,
    device_graph,
    shuffled_indices_for,
    walk_tables_for,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "scale_demo.py")
PAIRS = dict(n=5_000, draws=60_000)
TOY = dict(n=20_000, draws=200_000, seeds=4_096, queries=8_192, walks=8,
           steps=3, bucket=32)
LOSS_RTOL = 1e-5                  # tests/test_torch_port_train.py's fit
RANKS_TIMEOUT_S = 240
KEYS = ("nodes", "khi", "klo", "sizes")


def _script_pairs():
    """`rmat_pairs_chunked` of scripts/scale_demo.py, compiled alone."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
              and node.name == "rmat_pairs_chunked")
    scope = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), SCRIPT, "exec"),
         scope)
    return scope["rmat_pairs_chunked"]


@pytest.fixture(scope="module")
def pairs_graphs():
    """The script's pairs at PAIRS' size and both packages' CSR graphs of
    them."""
    edges = _script_pairs()(PAIRS["n"], PAIRS["draws"], 0)
    return (csr_from_edges(edges, num_nodes=PAIRS["n"]),
            jax_csr_from_edges(edges, num_nodes=PAIRS["n"]))


@pytest.mark.parametrize("chunk", [7_000, 20_000_000])
def test_rmat_pairs_chunked_match_the_script(chunk):
    """Several chunks (the last one short) and one chunk."""
    want = _script_pairs()(PAIRS["n"], PAIRS["draws"], 0, chunk=chunk)
    got = rmat_pairs_chunked(PAIRS["n"], PAIRS["draws"], 0, chunk=chunk)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] != got[:, 1]).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_device_graph_is_jax_int32_layout(pairs_graphs, seed, monkeypatch):
    g, jg = pairs_graphs
    g = dataclasses.replace(g)            # a fresh object: no device cache
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    jindptr, jindices = jax_device_graph(jg)
    jsh = jax_shuffled(jg, seed)
    jetab, jstab = jwalk.build_walk_tables(jindptr, jindices, jsh)
    indptr, indices = device_graph(g, "cpu")
    sh = shuffled_indices_for(g, seed, "cpu")
    etab, stab = walk_tables_for(g, seed, "cpu")
    for name, got, want in (("indptr", indptr, jindptr),
                            ("indices", indices, jindices),
                            ("shuffle", sh, jsh), ("etab", etab, jetab),
                            ("stab", stab, jstab)):
        assert got.dtype == torch.int32, name
        assert np.asarray(want).dtype == np.int32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    # chunks of 1000 edges, the last one short, against one chunk
    monkeypatch.setattr(twalk, "TABLE_CHUNK", 1000)
    chunked = twalk.build_walk_tables(indptr, indices, sh)
    monkeypatch.setattr(twalk, "TABLE_CHUNK", g.num_edges)
    whole = twalk.build_walk_tables(indptr, indices, sh)
    for got, want in zip(chunked, whole):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    gb = cached_graph_bytes(g, "cpu")
    assert gb["per_edge"] == 32 and gb["indptr"] == 4 * (g.num_nodes + 1)


def test_int32_guard_raises_at_2_31_edges():
    check_int32_edges(MAX_DEVICE_EDGES)
    big = CSRGraph(indptr=np.array([0, 2**31], np.int64),
                   indices=np.broadcast_to(np.int32(0), (2**31,)))
    assert big.num_edges == 2**31
    with pytest.raises(ValueError, match="2,147,483,648 directed edges"):
        big.to("cpu")
    with pytest.raises(ValueError, match="2,147,483,648 directed edges"):
        shuffled_indices_for(big, 0, "cpu")
    # the large-graph path refuses such a graph before drawing its pairs
    with pytest.raises(ValueError, match="2,147,483,648 directed entries"):
        scale_demo.run_device(**dict(TOY, draws=2**30), device="cpu",
                              log=lambda msg: None)


@pytest.fixture(scope="module")
def toy_device_run():
    """The toy run, its samplings' sets ("cold", "warm") recorded from
    the sampler calls as `run_device` makes them."""
    calls, sample = [], scale_demo.sample_gsets_device_keys

    def recorded(*args, **kw):
        calls.append(sample(*args, **kw))
        return calls[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scale_demo, "sample_gsets_device_keys", recorded)
        res = scale_demo.run_device(**TOY, device="cpu", dtype="float32",
                                    log=lambda msg: None)
    assert len(calls) == 2 and calls[1] is res["sets"]["warm"]
    return res, dict(zip(("cold", "warm"), calls))


@pytest.fixture(scope="module")
def jax_device_run():
    """scripts/scale_demo.py:main_device's calls at TOY's size, Net in
    float32."""
    edges = _script_pairs()(TOY["n"], TOY["draws"], 0)
    jg = jax_csr_from_edges(edges, num_nodes=TOY["n"], symmetrize=True)
    seeds = np.arange(TOY["seeds"], dtype=np.int32)
    kw = dict(num_walks=TOY["walks"], num_steps=TOY["steps"],
              bucket=TOY["bucket"], block_size=65536)
    cold = jax_sample(jg, seeds, seed=0, **kw)
    warm = jax_sample(jg, seeds, seed=1, shuffle_seed=0, **kw)
    model = JaxNet(input_dim=TOY["steps"] + 1, hidden_dim=96, aggrs="mean",
                   dropout=0.1, dtype="float32")
    trainer = jax_trainer(model, warm, JaxTrainConfig(batch_size=4096,
                                                      lr=1e-3))
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, TOY["seeds"], size=(2, TOY["queries"])
                                 ).astype(np.int32))
    labels = jnp.asarray((rng.random(TOY["queries"]) < 0.5
                          ).astype(np.float32))
    params, opt_state = trainer.init(jax.random.PRNGKey(0),
                                     np.asarray(q[:, :4096]))
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        params, opt_state, ls, _ = trainer.fit(params, opt_state, q, labels,
                                               sub, 4)
        losses.append(np.asarray(ls))
    return jg, {"cold": cold, "warm": warm}, losses


def test_device_mode_matches_jax(toy_device_run, jax_device_run):
    res, sets = toy_device_run
    jg, jsets, (jcold, jwarm) = jax_device_run
    g = res["graph"]
    assert res["nnz"] == jg.num_edges
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    for which in ("cold", "warm"):
        for k in KEYS:
            got = getattr(sets[which], k).numpy()
            want = np.asarray(getattr(jsets[which], k)).view(np.int32)
            np.testing.assert_array_equal(got, want, err_msg=f"{which} {k}")
    np.testing.assert_allclose(res["losses_cold"].numpy(), jcold,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res["losses_warm"].numpy(), jwarm,
                               rtol=LOSS_RTOL)
    assert res["graph_bytes"]["per_edge"] == 32
    assert {"rmat", "ingest", "upload", "shuffle", "tables", "sample_cold",
            "sample_warm", "fit_cold", "fit_warm"} <= set(res["stages"])
    assert res["sets_per_s"] > 0 and res["queries_per_s"] > 0


def test_partitioned_mode_matches_jax_partition_csr(jax_device_run):
    res = scale_demo.run_partitioned(
        TOY["n"], TOY["draws"], TOY["seeds"], TOY["walks"], TOY["steps"],
        ranks=2, device="cpu", timeout_s=RANKS_TIMEOUT_S,
        log=lambda msg: None)
    jg = jax_device_run[0]
    jp = jpart.partition_csr(jg, 2, seed=0)
    emax = int(jp.indices.shape[1])
    words = 2 + (6 if jp.etab is not None else 0)
    assert (res["nnz"], res["emax"], res["words_per_edge"]) == (
        jg.num_edges, emax, words)
    assert res["full_bytes"] == jg.num_edges * 4 * words
    assert res["part_bytes"] == emax * 4 * words
    assert res["rows"] == TOY["seeds"] and res["sets_per_s"] > 0


def test_card_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SUREL_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale_demo.run_device(**TOY, device="cuda", log=lambda msg: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale_demo.run_1m(device="cuda", log=lambda msg: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        scale_demo.run_partitioned(TOY["n"], TOY["draws"], TOY["seeds"],
                                   TOY["walks"], TOY["steps"], ranks=2,
                                   device="cuda", log=lambda msg: None)
    for mode in ("device", "1m", "partitioned"):
        with pytest.raises(RuntimeError, match="CUDA"):
            scale_demo.main([mode])
