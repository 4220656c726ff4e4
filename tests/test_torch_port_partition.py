"""PyTorch port, edge-partitioned graphs and frontier-exchange sampling
(`surel_plus_tpu_torch/parallel/partition.py`) held to the JAX package's
`parallel/partition.py`.

`partition_csr` is compared in this process, tables included, exactly.
One launch of four gloo ranks on the CPU (tests/_torch_port_ranks.py:
`partition_cases`) runs the samplers fed JAX's bits (the step keys'
`jax.random.bits` at the global [n_pad, M] shape): the probe and the
capacity routing, over the edge tables and the bare exchange, a forced
overflow (capacity slack 0.05, so the probe answers every step) and the
grouped sampler at group sizes 1, 2 and 4; each rank's rows must equal
JAX's partitioned sampler's (on four virtual devices) exactly. Unfed,
the port draws the same bits itself (each rank its rows of the global
draw of `prng_key(seed)`'s step keys), and its sets must equal JAX's
partitioned sets exactly too. The partitioned sets
then move to their graph shards and feed one keys step, held to JAX's
step on JAX's sets (loss rtol 1e-5, gradients and parameters as in
tests/test_torch_port_dist.py). Two processes joined over tcp://
(`init_distributed`) mirror tests/test_multihost.py.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import walk as jwalk
from surel_plus_tpu.ops.join import make_keys_join
from surel_plus_tpu.ops.sampler import device_graph as jax_device_graph
from surel_plus_tpu.ops.sampler import shuffled_indices_for as jax_shuffled
from surel_plus_tpu.parallel import dist as jdist
from surel_plus_tpu.parallel import partition as jpart
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.sampler import device_graph, walk_tables_for
from surel_plus_tpu_torch.parallel import partition as tpart
from surel_plus_tpu_torch.parallel.launch import run_ranks
from _torch_port_ranks import assert_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TESTS = os.path.dirname(os.path.abspath(__file__))
GRAPH = (500, 3000, 5)
N_SEEDS, M, S, SEED, H, LR = 498, 11, 3, 17, 16, 1e-3
RANKS_TIMEOUT_S = 240
KEYS = ("nodes", "khi", "klo", "sizes")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_bits(n_pad: int) -> np.ndarray:
    """JAX's draws for the steps after the first hop at the global block
    shape: [S - 1, n_pad, M] values in [0, 2^32)."""
    keys = jax.random.split(jax.random.PRNGKey(SEED), S - 1)
    return np.stack([np.asarray(jax.random.bits(k, (n_pad, M),
                                                dtype=jnp.uint32))
                     for k in keys]).astype(np.int64)


def _as_sets(nodes, sizes, hi, lo):
    return {"nodes": np.asarray(nodes), "sizes": np.asarray(sizes),
            "khi": np.asarray(hi).view(np.int32),
            "klo": np.asarray(lo).view(np.int32)}


def _jax_single(g, seeds, n_pad):
    """JAX's one-device sample_block over the padded seed block, trimmed
    (the reference its partitioned samplers equal)."""
    pad = np.zeros(n_pad, np.int32)
    pad[:len(seeds)] = seeds
    indptr, indices = jax_device_graph(g)
    out = jwalk.sample_block(indptr, indices, jax_shuffled(g, SEED),
                             jnp.asarray(pad), jax.random.PRNGKey(SEED),
                             num_walks=M, num_steps=S, bucket=M * S + 1)
    return {k: v[:len(seeds)] for k, v in _as_sets(*out).items()}


def _batch(rng, dp):
    B = dp * 16
    edges = rng.integers(0, N_SEEDS, size=(2, B)).astype(np.int32)
    labels = (rng.random(B) < 0.5).astype(np.float32)
    return edges, labels, np.ones(B, np.float32)


def _jax_step(sets, edges, labels, weights, mesh):
    """(inputs' params, JAX's (loss, params, mu) after one distributed
    step of a mean Net (Adam, lr LR) over `sets`)."""
    join = make_keys_join(M, S)
    arr = lambda k: jnp.asarray(sets[k].view(np.uint32) if k in ("khi",
                                "klo") else sets[k])
    joined = join(arr("nodes"), arr("khi"), arr("klo"), arr("sizes"),
                  jnp.asarray(edges))
    model = JaxNet(input_dim=S + 1, hidden_dim=H, dropout=0.0,
                   fused_hidden=False)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 1), jnp.float32), joined)
    from surel_plus_tpu.spg.spg import SpGKeys as JaxSpGKeys

    spgk = JaxSpGKeys(nodes=arr("nodes"), khi=arr("khi"), klo=arr("klo"),
                      sizes=arr("sizes"), num_walks=M, num_steps=S)
    opt = optax.adam(LR)
    step = jdist.DistributedKeysTrainStep(model, opt, mesh,
                                          jdist.shard_spg_keys(spgk, mesh))
    p, st, loss = step(params, opt.init(params), jnp.asarray(edges),
                       jnp.asarray(labels), jnp.asarray(weights),
                       jax.random.PRNGKey(1))
    flat = lambda t: {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, t)).items()}
    return flat(params), (float(loss), flat(p), flat(st[0].mu))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the ranks' results, JAX's partitioned sets, JAX's step)."""
    g = jax_rmat(*GRAPH)
    seeds = np.arange(N_SEEDS, dtype=np.int32)
    n_pad = -(-N_SEEDS // 4) * 4
    mesh = jdist.make_mesh(4)
    jsets = _as_sets(*(lambda s: (s.nodes, s.sizes, s.khi, s.klo))(
        jpart.sample_gsets_partitioned(jpart.partition_csr(g, 4, seed=SEED),
                                       seeds, M, S, mesh, seed=SEED)))
    edges, labels, weights = _batch(np.random.default_rng(0),
                                    mesh.shape["data"])
    params, jstep = _jax_step(jsets, edges, labels, weights, mesh)
    inputs = dict(graph=GRAPH, seeds=seeds, M=M, S=S, seed=SEED, lr=LR,
                  hidden=H, bits=_jax_bits(n_pad), params=params,
                  edges=edges, labels=labels, weights=weights)
    payload = tmp_path_factory.mktemp("partition_ranks")
    torch.save(inputs, payload / "inputs.pt")
    results = run_ranks("_torch_port_ranks:partition_cases", 4, "gloo",
                        "cpu", str(payload), RANKS_TIMEOUT_S,
                        sys_path=[TESTS])
    return inputs, results, jsets, jstep, _jax_single(g, seeds, n_pad)


def _whole(results, pick):
    """The ranks' blocks of one run, in rank order, concatenated."""
    blocks = [pick(r) for r in results]
    starts = [b[0] for b in blocks]
    assert starts == sorted(starts)
    return {k: np.concatenate([b[1][k] for b in blocks]) for k in KEYS}


def _assert_sets(got, want, what):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("edge_tables", [True, False])
def test_partition_csr_matches_jax(n_shards, edge_tables):
    g, jg = rmat_graph(*GRAPH), jax_rmat(*GRAPH)
    got = tpart.partition_csr(g, n_shards, seed=SEED,
                              edge_tables=edge_tables)
    want = jpart.partition_csr(jg, n_shards, seed=SEED,
                               edge_tables=edge_tables)
    assert (got.rows_per_shard, got.num_nodes, got.num_shards,
            got.num_edges) == (want.rows_per_shard, want.num_nodes,
                               want.num_shards, want.num_edges)
    for k in ("indptr", "indices", "shuffled", "etab", "stab"):
        a, b = getattr(got, k), getattr(want, k)
        if not edge_tables and k in ("etab", "stab"):
            assert a is None and b is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_jax_partitioned_equals_its_single_device(run):
    """The reference the cases below hold the port to."""
    _, _, jsets, _, single = run
    _assert_sets(jsets, single, "JAX partitioned vs one device")


@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("routing,slack", [("probe", 1.25),
                                           ("capacity", 1.25),
                                           ("capacity", 0.05)])
def test_partitioned_with_jax_bits_matches_jax(run, tables, routing, slack):
    _, results, jsets, _, _ = run
    got = _whole(results, lambda r: r["shards"][tables, routing, slack])
    _assert_sets(got, jsets, f"tables={tables} {routing} slack={slack}")


@pytest.mark.parametrize("group", [1, 2, 4])
def test_grouped_with_jax_bits_matches_jax(run, group):
    _, results, jsets, _, _ = run
    _assert_sets(_whole(results, lambda r: r["grouped"][group]), jsets,
                 f"group {group}")


def test_unfed_matches_the_ports_sample_block(run):
    """Unfed, each rank draws its rows of JAX's global draw itself (the
    counter offset): the sets equal JAX's partitioned sets, and the
    port's `sample_block` over the whole padded seed block with the key
    prng_key(seed)."""
    inputs, results, jsets, _, _ = run
    got = _whole(results, lambda r: r["unfed"])
    _assert_sets(got, jsets, "unfed")
    n_pad = len(inputs["bits"][0])
    pad = np.zeros(n_pad, np.int32)
    pad[:N_SEEDS] = inputs["seeds"]
    g = rmat_graph(*GRAPH)
    indptr, _ = device_graph(g, "cpu")
    etab, stab = walk_tables_for(g, SEED, "cpu")
    want = walk_ops.sample_block(indptr, etab, stab, torch.as_tensor(pad),
                                 num_walks=M, num_steps=S,
                                 bucket=M * S + 1,
                                 key=prng.prng_key(SEED))
    want = dict(zip(("nodes", "sizes", "khi", "klo"),
                    (x[:N_SEEDS].numpy() for x in want)))
    _assert_sets(got, want, "unfed against sample_block")


def test_partitioned_sets_feed_the_step(run):
    """shard_spg_keys moves each rank's block to its graph shard; the keys
    step over them equals JAX's over JAX's sets."""
    _, results, jsets, jstep, _ = run
    rps = -(-N_SEEDS // 2)
    for r, res in enumerate(results):
        g = r % 2
        for k in KEYS:
            want = jsets[k][g * rps:(g + 1) * rps]
            np.testing.assert_array_equal(res["sharded_rows"][k][:len(want)],
                                          want)
        assert_step(res["step"], jstep, f"rank {r}", 1e-5, LR)


def test_init_distributed_two_processes(tmp_path):
    """Two processes joined over tcp:// by init_distributed sample over a
    graph partitioned between them (JAX's bits) and take one keys step:
    their rows equal JAX's one-device sets, the loss JAX's."""
    world = 2
    g = jax_rmat(*GRAPH)
    seeds = np.arange(N_SEEDS, dtype=np.int32)
    n_pad = -(-N_SEEDS // world) * world
    single = _jax_single(g, seeds, n_pad)
    edges, labels, weights = _batch(np.random.default_rng(1), 1)
    params, jstep = _jax_step(single, edges, labels, weights,
                              jdist.make_mesh(2, graph_axis=2))
    torch.save(dict(graph=GRAPH, seeds=seeds, M=M, S=S, seed=SEED, lr=LR,
                    hidden=H, bits=_jax_bits(n_pad), params=params,
                    edges=edges, labels=labels, weights=weights),
               tmp_path / "inputs.pt")
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(TESTS), TESTS]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_torch_port_ranks.py"),
         address, str(world), str(r), str(tmp_path / f"out{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r}:\n{outs[r][-3000:]}"
    got = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
           for r in range(world)]
    assert [x["world"] for x in got] == [world, world]
    whole = {k: np.concatenate([x["sets"][k] for x in got]) for k in KEYS}
    _assert_sets(whole, single, "two processes")
    for x in got:
        assert np.isclose(x["loss"], jstep[0], rtol=1e-5), (x["loss"],
                                                            jstep[0])


def test_init_distributed_refuses_nccl_on_the_cpu():
    with pytest.raises(ValueError, match="NCCL"):
        tpart.init_distributed("127.0.0.1:1", 2, 0, backend="nccl",
                               device="cpu")
