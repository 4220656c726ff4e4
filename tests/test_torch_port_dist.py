"""PyTorch port, multi-device training and scoring
(`surel_plus_tpu_torch/parallel/dist.py`) held to the JAX package's
`parallel/dist.py` on the same inputs.

One launch of four gloo ranks on the CPU (`run_ranks`, the rank code in
tests/_torch_port_ranks.py) runs every path on the meshes (data, graph)
= (4, 1), (2, 2) and (1, 4); meanwhile this process runs JAX's
distributed steps and scorers on the conftest's virtual devices
(`make_mesh(4, graph_axis=...)`) over the same JAX-sampled keys and
JAX-initialized weights (`convert.params_from_flax`).

JAX runs its mean step and scorer on every mesh, and its other programs
on the (2, 2) mesh alone (its results do not depend on the mesh beyond
float32 rounding: tests/test_dist.py holds them to one device).

Tolerances (tests/test_dist.py's): one step's loss rtol 1e-5 (attn and
lstm 1e-4, their sums in other orders), the parameters after it rtol
1e-4 / atol 1e-6; the step's averaged gradients (Adam's first moment,
0.1 g in both optimizers) rtol 1e-4 / atol 1e-6, as
tests/test_torch_port_train.py holds a step's; scores and metrics within
1e-5; row gathers exactly. Where JAX's gradient is below 1e-6 it is
rounding noise (the attention gate's bias, zero in exact arithmetic, and
a few LSTM weights): Adam's first step moves such a parameter by about
lr times the noise's sign, so it is held to 2 lr there.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import HONet as JaxHONet
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import gather_join
from surel_plus_tpu.ops.join import join_gathered_hkeys as jax_hjoin_rows
from surel_plus_tpu.ops.join import make_keys_hjoin, make_keys_join
from surel_plus_tpu.ops.sampler import sample_gsets, sample_gsets_device_keys
from surel_plus_tpu.parallel import dist as jdist
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.ops.join import unpack_key_features
from surel_plus_tpu_torch.parallel import mesh as tmesh
from surel_plus_tpu_torch.parallel.launch import run_ranks
from _torch_port_ranks import assert_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TESTS = os.path.dirname(os.path.abspath(__file__))
N, M, S, H, B = 200, 8, 2, 16, 32
GRAPH_AXES = (1, 2, 4)
KEY_CASES = {"mean": ("mean", None), "mean_fused": ("mean", True),
             "attn": ("attn", None), "lstm": ("lstm", None)}
LOSS_RTOL = {"attn": 1e-4, "lstm": 1e-4}
LR = 1e-2
GATE_BIAS = "aggr.gate_nn.bias"
RANKS_TIMEOUT_S = 240
# JAX's programs run on every mesh for the mean step and the scorer, and
# on this graph axis alone for the rest (JAX's results do not depend on
# the mesh beyond float32 rounding: tests/test_dist.py holds them to its
# single-device step)
REF_AXIS = 2


def _np(x):
    return np.asarray(x)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _flat(params):
    return params_from_flax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the ranks' results, JAX's references by graph axis)."""
    g = rmat_graph(N, 1000, seed=0)
    seeds = np.arange(N, dtype=np.int32)
    spgk = sample_gsets_device_keys(g, seeds, num_walks=M, num_steps=S,
                                    seed=1, block_size=N)
    spg = sample_gsets(g, seeds, num_walks=M, num_steps=S, seed=1,
                       block_size=N)
    rng = np.random.default_rng(0)
    edges = rng.integers(0, N, size=(2, B)).astype(np.int32)
    hedges = rng.integers(0, N, size=(3, B)).astype(np.int32)
    labels = (np.arange(B) % 2).astype(np.float32)
    weights = np.ones(B, np.float32)
    ids = rng.integers(0, N, size=(2, 16)).astype(np.int32)
    srng = np.random.default_rng(3)
    score_edges = srng.integers(0, N, size=(2, 100)).astype(np.int32)
    score_hedges = srng.integers(0, N, size=(3, 100)).astype(np.int32)
    pos, neg = score_edges[:, :20], score_edges[:, 20:100]
    hpos, hneg = score_hedges[:, :20], score_hedges[:, 20:100]

    enc0 = jnp.zeros((1, 1), jnp.float32)
    kjoined = make_keys_join(M, S)(spgk.nodes, spgk.khi, spgk.klo,
                                   spgk.sizes, jnp.asarray(edges))
    hjoined = make_keys_hjoin(M, S)(spgk.nodes, spgk.khi, spgk.klo,
                                    spgk.sizes, jnp.asarray(hedges))
    dev = spg.device()
    tjoined = gather_join(dev.nodes, dev.eidx, dev.sizes, jnp.asarray(edges))
    key0 = jax.random.PRNGKey(0)
    models = {a: JaxNet(input_dim=S + 1, hidden_dim=H, aggrs=a, dropout=0.0,
                        key_layout=(M, S), fused_hidden=False)
              for a in ("mean", "attn", "lstm")}
    params = {a: m.init(key0, enc0, kjoined) for a, m in models.items()}
    tmodel = JaxNet(input_dim=S + 1, hidden_dim=H, aggrs="mean", dropout=0.0)
    params["table"] = tmodel.init(key0, dev.enc, tjoined)
    honet = JaxHONet(input_dim=S + 1, hidden_dim=H, dropout=0.0,
                     key_layout=(M, S))
    params["honet"] = honet.init(key0, enc0, hjoined)

    inputs = dict(
        graph=(N, 1000, 0), seeds=seeds, hidden=H, graph_axes=GRAPH_AXES,
        key_cases=KEY_CASES, edges=edges, hedges=hedges, labels=labels,
        weights=weights, ids=ids, score_edges=score_edges,
        score_hedges=score_hedges,
        inf_edge={"valid": (pos, neg), "test": (neg[:, :20], pos)},
        hinf_edge={"valid": (hpos, hneg), "test": (hpos, hneg)},
        spgk=dict(nodes=_np(spgk.nodes), khi=_bits(spgk.khi),
                  klo=_bits(spgk.klo), sizes=_np(spgk.sizes), num_walks=M,
                  num_steps=S),
        table=dict(nodes=spg.nodes, eidx=spg.eidx, sizes=spg.sizes,
                   enc=spg.enc, seeds=spg.seeds),
        params={k: {n: v.numpy() for n, v in _flat(p).items()}
                for k, p in params.items()})
    payload = tmp_path_factory.mktemp("dist_ranks")
    torch.save(inputs, payload / "inputs.pt")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(run_ranks, "_torch_port_ranks:dist_cases", 4,
                        "gloo", "cpu", str(payload), RANKS_TIMEOUT_S,
                        sys_path=[TESTS])

    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    jargs = (jnp.asarray(edges), jnp.asarray(labels), jnp.asarray(weights),
             jax.random.PRNGKey(9))

    def stepped(step, p, *args):
        """(loss, parameters, Adam's first moment mu = 0.1 g) after one
        step of JAX's distributed `step`."""
        p, st, loss = step(p, optimizer.init(p), *args)
        mu = {k: v.numpy() for k, v in _flat(st[1][0].mu).items()}
        return (float(loss), {k: v.numpy() for k, v in _flat(p).items()},
                mu)

    refs = {}
    for gp in GRAPH_AXES:
        mesh = jdist.make_mesh(4, graph_axis=gp)
        sspg = jdist.shard_spg_keys(spgk, mesh)
        ref = refs[gp] = {"shape": dict(mesh.shape)}
        ref["mean"] = stepped(jdist.DistributedKeysTrainStep(
            models["mean"], optimizer, mesh, sspg), params["mean"], *jargs)
        scorer = jdist.DistributedKeysScorer(models["mean"], mesh, sspg,
                                             batch_size=64)
        ref["scores"] = _np(scorer(params["mean"], score_edges))
        if gp != REF_AXIS:
            continue
        # the other programs once, on the (2, 2) mesh
        for a in ("attn", "lstm"):
            ref[a] = stepped(jdist.DistributedKeysTrainStep(
                models[a], optimizer, mesh, sspg), params[a], *jargs)
        ref["table"] = stepped(jdist.DistributedTrainStep(
            tmodel, optimizer, mesh, jdist.shard_spg(spg, mesh)),
            params["table"], *jargs)
        ref["honet"] = stepped(jdist.DistributedKeysHTrainStep(
            honet, optimizer, mesh, sspg), params["honet"],
            jnp.asarray(hedges), *jargs[1:])
        for metric in ("Hits@50", "MRR", "AUC"):
            ref[metric] = jdist.evaluate_distributed(
                scorer, params["mean"], inputs["inf_edge"], metric)[0]
        hscorer = jdist.DistributedKeysScorer(
            honet, mesh, sspg, batch_size=32, join_gathered=jax_hjoin_rows)
        ref["hscores"] = _np(hscorer(params["honet"], score_hedges))
        ref["hMRR"] = jdist.evaluate_distributed(
            hscorer, params["honet"], inputs["hinf_edge"], "MRR")[0]
    results = ranks.result()
    pool.shutdown()
    return inputs, results, refs


def _ref(refs, gp, what):
    """JAX's reference for `what` on graph axis gp (REF_AXIS where JAX ran
    it on one mesh only)."""
    return refs[gp][what] if what in refs[gp] else refs[REF_AXIS][what]


@pytest.mark.parametrize("gp", GRAPH_AXES)
def test_mesh_shapes_and_coordinates(run, gp):
    _, results, refs = run
    assert results[0][gp]["shape"] == refs[gp]["shape"]
    assert results[0][gp]["shape"] == {"data": 4 // gp, "graph": gp}


@pytest.mark.parametrize("gp", GRAPH_AXES)
def test_row_gathers_equal_the_rows(run, gp):
    """The psum and the all-to-all gathers give the store's rows."""
    inputs, results, _ = run
    ids = inputs["ids"]
    want = [inputs["spgk"]["nodes"][ids], inputs["spgk"]["klo"][ids]]
    for r in range(4):
        for kind in ("gather_psum", "gather_a2a"):
            for got, w in zip(results[r][gp][kind], want):
                np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("case", sorted(KEY_CASES) + ["table", "honet"])
@pytest.mark.parametrize("gp", GRAPH_AXES)
def test_train_steps_match_jax(run, gp, case):
    """One step's loss and the parameters after it, on every rank (the
    replicated parameters must stay equal)."""
    _, results, refs = run
    aggrs = KEY_CASES[case][0] if case in KEY_CASES else case
    for r in range(4):
        assert_step(results[r][gp][case], _ref(refs, gp, aggrs),
                    f"rank {r} {case} gp={gp}", LOSS_RTOL.get(aggrs, 1e-5),
                    LR)
    for r in range(1, 4):
        for name, v in results[0][gp][case][1].items():
            np.testing.assert_array_equal(results[r][gp][case][1][name], v)


@pytest.mark.parametrize("gp", GRAPH_AXES)
@pytest.mark.parametrize("what", ["scores", "hscores"])
def test_scorers_match_jax(run, gp, what):
    """Scores come back replicated, in global column order."""
    _, results, refs = run
    for r in range(4):
        got, want = results[r][gp][what], _ref(refs, gp, what)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gp", GRAPH_AXES)
@pytest.mark.parametrize("metric", ["Hits@50", "MRR", "AUC", "hMRR"])
def test_evaluate_distributed_matches_jax(run, gp, metric):
    _, results, refs = run
    got, want = results[0][gp][metric], _ref(refs, gp, metric)
    if metric == "Hits@50":
        assert set(got) == set(want) == {"Hits@10", "Hits@20", "Hits@50",
                                         "Hits@100"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("gp", GRAPH_AXES)
def test_sharded_sampling(run, gp):
    """sample_gsets_sharded: each rank's block is `sample_block` over its
    seeds from its own stream; the sets hold their root with count M at
    column 0 and a landing mass of M a column (tests/test_dist.py:
    146-168); shard_spg_keys moves the blocks to their graph shards."""
    inputs, results, _ = run
    seeds = inputs["seeds"]
    blocks = []
    for r in range(4):
        start, n, sets = results[r][gp]["sharded"]
        assert n == N and start == r * (N // 4)
        for k, want in zip(("nodes", "sizes", "khi", "klo"),
                           results[r][gp]["sharded_ref"]):
            np.testing.assert_array_equal(sets[k], want)
        blocks.append(sets)
    whole = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    nodes, sizes = whole["nodes"], whole["sizes"]
    assert nodes.shape == (N, M * S + 1)
    feats = unpack_key_features(torch.as_tensor(whole["khi"]),
                                torch.as_tensor(whole["klo"]), M,
                                S).numpy() * M
    valid = np.arange(nodes.shape[1])[None, :] < sizes[:, None]
    root_pos = np.argmax(nodes == seeds[:, None], axis=1)
    assert np.all(nodes[np.arange(N), root_pos] == seeds)
    assert np.allclose(feats[np.arange(N), root_pos, 0], M)
    assert np.allclose((feats * valid[:, :, None]).sum(axis=1), M)
    gpn = results[0][gp]["shape"]["graph"]
    rps = -(-N // gpn)
    for r in range(4):
        g = r % gpn
        rows = results[r][gp]["sharded_rows"]
        for k in whole:
            want = whole[k][g * rps:(g + 1) * rps]
            np.testing.assert_array_equal(rows[k][:len(want)], want)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    from surel_plus_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, device="cpu", timeout_s=RANKS_TIMEOUT_S)
    assert len(res) == 4 and res[0]["mesh"] == {"data": 2, "graph": 2}
    for r in res:
        assert all(np.isfinite(v) for k, v in r.items() if k != "mesh")
        assert r == res[0]
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("backend,device,world,cards", [
    ("nccl", "cuda", 2, 1), ("nccl", "cuda", 4, 2), ("nccl", "cpu", 1, 1),
    ("mpi", "cpu", 1, 0)])
def test_backend_checks_raise(backend, device, world, cards):
    """NCCL asked for two ranks on one card (or for the CPU) raises before
    NCCL does; so does an unknown backend."""
    with pytest.raises(ValueError):
        tmesh.check_backend(backend, device, world, cards=cards)
    tmesh.check_backend("gloo", "cpu", world, cards=cards)
    tmesh.check_backend("gloo", "cuda", world, cards=1)


def test_run_ranks_refuses_nccl_ranks_sharing_a_card(tmp_path):
    with pytest.raises(ValueError, match="NCCL"):
        run_ranks("_torch_port_ranks:echo", 2, "nccl", "cuda",
                  str(tmp_path), 30, sys_path=[TESTS])
    assert not list(tmp_path.glob("rank*.log"))


def test_run_ranks_raises_on_a_failed_rank(tmp_path):
    """A rank that raises fails the launch with its output, and the rank
    left waiting in a collective is killed, well before the limit."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[.*1.*\] of 3 exited"
                       ) as err:
        run_ranks("_torch_port_ranks:fails", 3, "gloo", "cpu",
                  str(tmp_path), 60, sys_path=[TESTS])
    assert "--- rank 1:" in str(err.value)
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 50


def test_run_ranks_returns_each_ranks_result(tmp_path):
    got = run_ranks("_torch_port_ranks:echo", 3, None, "cpu", str(tmp_path),
                    60, sys_path=[TESTS])
    assert got == [(r, 3, "gloo", "cpu", 6) for r in range(3)]
