"""PyTorch port, the scalar encoders: the host PPR push (`ops/ppr.py`,
`csrc/ppr_host.cpp`), the device PPR (`ops/ppr_device.py`), the DEG / SPD
/ PPR encodings and their padded sets (`ops/encoders.py`), the float-pair
join on the merge, the Net's scalar branch and the scalar device trainer,
each against the JAX package on the same inputs.

Tolerances, with their reasons:
- the host push: exact (both packages build the same C++ source, JAX's
  with -march=native as well, which changes no bit here; the plain
  Python push against JAX's is the same loop);
- `topk_ppr_matrix`: 1e-12 (the same float64 normalizations);
- the device PPR: scores 1e-6 (JAX sums each row's edges as a difference
  of running sums, the port directly: rounding apart), nodes equal where
  the scores are not tied (`torch.topk` and `lax.top_k` order ties
  differently); against the host push 5e-4 with 90% of the support
  shared, the JAX test's bound (tests/test_ppr.py:50-78);
- the encodings: the same sparsity, values within one float32 ulp (the
  l1 normalization is scipy's here, sklearn's in JAX, both with float64
  row sums);
- the padded sets and the join: exact;
- Net logits: rtol = atol = 1e-4 in fp32;
- the trainer: predict scores 1e-5; one step's loss rtol 1e-5 and
  gradients rtol 1e-4, atol 1e-6 (the attention gate's bias, whose
  gradient is 0 up to rounding, atol 1e-5), as
  tests/test_torch_port_table.py holds the table trainer; the 2-epoch
  fit's parameters rtol 1e-4, atol 1e-5 (the gate's bias 2 lr a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from surel_plus_tpu.graph import ring_of_cliques as jax_ring_of_cliques
from surel_plus_tpu.graph import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import encoders as jax_enc
from surel_plus_tpu.ops import ppr as jax_ppr
from surel_plus_tpu.ops.ppr_device import ppr_topk_device as jax_ppr_device
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import DeviceTrainer as JaxDeviceTrainer
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import ring_of_cliques, rmat_graph
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import encoders, ppr
from surel_plus_tpu_torch.ops.ppr_device import ppr_topk_device
from surel_plus_tpu_torch.spg import SpGDevice
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import batch_loss
from surel_plus_tpu_torch.train.scalar import scalar_trainer_from_spg
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_host_engine import run_toy_cli

N, H = 200, 16
ALPHA, EPS, TOPK = 0.5, 1e-4, 16
AGGRS = ("attn", "lstm", "mean")
GATE_BIAS = "aggr.gate_nn.bias"   # gradient 0 up to rounding
BS, E, EPOCHS, LR = 8, 21, 2, 1e-2   # E % BS != 0

GRAPHS = ("ring", "rmat")


def _graphs(name):
    """The JAX package's graph and the port's, which must be equal: an
    rmat graph, or a ring of cliques (many tied PPR scores)."""
    if name == "rmat":
        jg, g = jax_rmat_graph(300, 2400, seed=7), rmat_graph(300, 2400,
                                                              seed=7)
    else:
        jg, g = jax_ring_of_cliques(6, 5), ring_of_cliques(6, 5)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    return jg, g


def _weighted(g):
    """g with seeded positive weights, as a `--use_weight` graph has."""
    w = np.random.default_rng(5).uniform(0.5, 3.0, g.num_edges)
    return type(g)(indptr=g.indptr, indices=g.indices,
                   data=w.astype(np.float32))


# ------------------------------------------------------------ host push
@pytest.mark.parametrize("name", GRAPHS)
def test_ppr_topk_matches_jax(name):
    jg, g = _graphs(name)
    seeds = np.arange(g.num_nodes, dtype=np.int32)[::-1].copy()
    want = jax_ppr.ppr_topk(jg.indptr, jg.indices, seeds, ALPHA, 1e-5, 20)
    got = ppr.ppr_topk(g.indptr, g.indices, seeds, ALPHA, 1e-5, 20)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w)
    assert got[2].min() > 0 and ppr.num_threads() >= 1


@pytest.mark.parametrize("name", GRAPHS)
def test_ppr_push_plain_matches_jax(name):
    jg, g = _graphs(name)
    seeds = np.array([0, 3, g.num_nodes - 1], dtype=np.int32)
    want = jax_ppr._ppr_push_numpy(jg.indptr, jg.indices, seeds, ALPHA,
                                   EPS, TOPK)
    got = ppr.ppr_push_plain(g.indptr, g.indices, seeds, ALPHA, EPS, TOPK)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w)


def test_host_push_build_failure_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's message;
    nothing falls back to the Python loop."""
    bad = tmp_path / "ppr_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ppr, "SOURCE", bad)
    monkeypatch.setattr(ppr, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(ppr, "_LIB", None)
    g = ring_of_cliques(3, 4)
    with pytest.raises(RuntimeError, match="failed") as err:
        ppr.ppr_topk(g.indptr, g.indices, np.array([0]), ALPHA, EPS, TOPK)
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("norm", ["row", "sym", "col"])
def test_topk_ppr_matrix_matches_jax(norm):
    jg, g = _graphs("rmat")
    idx = np.arange(0, g.num_nodes, 3)
    want = jax_ppr.topk_ppr_matrix(jg, ALPHA, EPS, idx, TOPK,
                                   normalization=norm)
    got = ppr.topk_ppr_matrix(g, ALPHA, EPS, idx, TOPK, normalization=norm)
    assert isinstance(got, sp.csr_matrix) and got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        ppr.topk_ppr_matrix(g, ALPHA, EPS, idx, TOPK, normalization="x")


# ------------------------------------------------------------ device PPR
@pytest.mark.parametrize("name", GRAPHS)
def test_ppr_topk_device_matches_jax(name):
    jg, g = _graphs(name)
    seeds = np.arange(g.num_nodes, dtype=np.int32)
    jn, js, jc = jax_ppr_device(jg.indptr, jg.indices, seeds, ALPHA, EPS,
                                TOPK, block=16)
    pn, ps, pc = ppr_topk_device(g.indptr, g.indices, seeds, ALPHA, EPS,
                                 TOPK, block=16, device="cpu")
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pc, jc)
    # a slot's node is fixed where its score is apart from its neighbours'
    # (the last slot's may tie with a node past the top k)
    gap = 1e-5
    pad = np.full((len(seeds), 1), np.inf)
    left = np.abs(np.diff(np.concatenate([pad, js], 1), axis=1)) > gap
    right = np.abs(np.diff(np.concatenate([js, js[:, -1:]], 1),
                           axis=1)) > gap
    untied = left & right & (js > 0)
    assert untied.sum() > len(seeds)
    np.testing.assert_array_equal(pn[untied], jn[untied])


def test_ppr_device_matches_host_push():
    """The device PPR against the host push at the JAX test's settings
    (tests/test_ppr.py:50-90): each seed's scores within 5e-4 on a ring
    of cliques and an rmat graph, and through `topk_ppr_matrix`'s two
    methods 90% of the support shared with the scores on it within
    5e-4."""
    for g in (ring_of_cliques(4, 5), rmat_graph(300, 2400, seed=7)):
        seeds = np.array([0, 7, g.num_nodes - 1], dtype=np.int32)
        dn, ds, dc = ppr_topk_device(g.indptr, g.indices, seeds, 0.15,
                                     1e-6, 20, block=2, device="cpu")
        hn, hs, hc = ppr.ppr_topk(g.indptr, g.indices, seeds, 0.15, 1e-6,
                                  20)
        for i in range(len(seeds)):
            dense = np.zeros((2, g.num_nodes))
            dense[0, dn[i, :dc[i]]] = ds[i, :dc[i]]
            dense[1, hn[i, :hc[i]]] = hs[i, :hc[i]]
            assert np.abs(dense[0] - dense[1]).max() < 5e-4
            assert np.all(np.diff(ds[i, :dc[i]]) <= 1e-9)
    # on the rmat graph: the ring's symmetric nodes tie exactly, and which
    # of them the top k keeps is open in either method
    idx = np.arange(g.num_nodes)
    md = ppr.topk_ppr_matrix(g, 0.15, 1e-6, idx, 20, normalization="sym",
                             method="device", device="cpu").toarray()
    mh = ppr.topk_ppr_matrix(g, 0.15, 1e-6, idx, 20,
                             normalization="sym").toarray()
    both = (md > 0) & (mh > 0)
    assert both.sum() >= 0.9 * (mh > 0).sum()
    assert np.abs(md[both] - mh[both]).max() < 5e-4


def test_ppr_device_within_the_push_bound():
    """At the CLI's settings (alpha 0.5, eps 1e-4) on a power-law graph
    the push stops with each node's residual below alpha eps d_u, so its
    score of a node v falls short of the exact one by less than eps d_v
    (PPR's symmetry on an undirected graph); the device scores keep to
    that bound on the nodes both top-k lists hold, and to 1e-6 of a
    float64 power iteration."""
    _, g = _graphs("rmat")
    seeds = np.arange(0, g.num_nodes, 5, dtype=np.int32)
    dn, ds, dc = ppr_topk_device(g.indptr, g.indices, seeds, ALPHA, EPS,
                                 TOPK, device="cpu")
    hn, hs, hc = ppr.ppr_topk(g.indptr, g.indices, seeds, ALPHA, EPS, TOPK)
    deg = np.diff(g.indptr).astype(np.float64)
    adj = sp.csr_matrix((np.ones(g.num_edges), g.indices, g.indptr),
                        shape=(g.num_nodes, g.num_nodes))
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    for i, s in enumerate(seeds):
        e = np.zeros(g.num_nodes)
        e[s] = 1.0
        x = ALPHA * e
        for _ in range(100):
            x = ALPHA * e + (1 - ALPHA) * (adj @ (x * inv))
        np.testing.assert_allclose(ds[i, :dc[i]], x[dn[i, :dc[i]]],
                                   rtol=0, atol=1e-6)
        host = dict(zip(hn[i, :hc[i]], hs[i, :hc[i]]))
        for v, score in zip(dn[i, :dc[i]], ds[i, :dc[i]]):
            if v in host:
                assert -1e-6 <= score - host[v] <= EPS * deg[v] + 1e-6


# ------------------------------------------------------------ encodings
@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
@pytest.mark.parametrize("kind", ["DEG", "SPD", "PPR"])
def test_encoding_matches_jax(kind, weighted):
    jg, g = _graphs("rmat")
    if weighted:
        jg, g = _weighted(jg), _weighted(g)
    x = jax_ppr.topk_ppr_matrix(jg, ALPHA, EPS, np.arange(g.num_nodes),
                                TOPK, normalization="sym")
    want, want_agg = jax_enc.encoding(x.copy(), jg.to_scipy(), kind)
    got, agg = encoders.encoding(x.copy(), g.to_scipy(), kind)
    want, got = sp.csr_matrix(want), sp.csr_matrix(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_max_ulp(got.data.astype(np.float32),
                                    want.data.astype(np.float32), maxulp=1)
    assert (agg is None) == (want_agg is None)
    if agg is not None:
        np.testing.assert_array_max_ulp(
            sp.csr_matrix(agg).data.astype(np.float32),
            sp.csr_matrix(want_agg).data.astype(np.float32), maxulp=1)


def test_l1_normalize_rows_matches_sklearn():
    from sklearn.preprocessing import normalize

    rng = np.random.default_rng(3)
    m = sp.random(40, 30, density=0.2, format="csr", random_state=4,
                  dtype=np.float32)
    m.data = rng.normal(size=m.nnz).astype(np.float32)
    m[5] = 0                                   # a row that sums to 0
    for mat in (m, (m != 0).astype(np.int64)):
        want = normalize(mat, norm="l1", axis=1)
        got = encoders.l1_normalize_rows(mat)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("bucket", [None, 8, 64], ids=["whole", "cut",
                                                       "wide"])
def test_scalar_spg_from_csr_matches_jax(bucket):
    jg, g = _graphs("rmat")
    x = jax_ppr.topk_ppr_matrix(jg, ALPHA, EPS, np.arange(g.num_nodes),
                                TOPK, normalization="sym")
    x, _ = jax_enc.encoding(x, jg.to_scipy(), "SPD")
    seeds = np.arange(g.num_nodes, dtype=np.int32) + 7
    want = jax_enc.scalar_spg_from_csr(x.copy(), seeds=seeds, bucket=bucket)
    got = encoders.scalar_spg_from_csr(x.copy(), seeds=seeds, bucket=bucket)
    for f in ("nodes", "values", "sizes", "seeds"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.bucket == want.bucket
    dev = got.device("cpu")
    assert isinstance(dev, SpGDevice) and dev.enc.shape == (1, 1)
    assert dev.eidx.dtype == torch.float32


# ------------------------------------------------------------ join, Net
@pytest.fixture(scope="module")
def scalar_case():
    """JAX's PPR sets of the rmat graph (sym normalization, PPR
    encoding), query edges laid out column-major, JAX's join of them and
    each aggregator's flax weights (the LSTM's bias nonzero)."""
    jg, _ = _graphs("rmat")
    n = jg.num_nodes
    x = jax_ppr.topk_ppr_matrix(jg, ALPHA, EPS, np.arange(n), TOPK,
                                normalization="sym")
    x, _ = jax_enc.encoding(x.tocsr(), jg.to_scipy(), "PPR")
    sspg = jax_enc.scalar_spg_from_csr(x.tocsr())
    jdev = sspg.device()
    rng = np.random.default_rng(26)
    edges = np.asfortranarray(rng.integers(0, n, size=(12, 2)).T.astype(
        np.int32))
    edges[:, 3] = edges[::-1, 3]              # a pair both ways round
    edges[:, 4] = (edges[0, 4], edges[0, 4])  # a node with itself
    jj = jax_enc.gather_join_scalar(jdev.nodes, jdev.eidx, jdev.sizes,
                                    jnp.asarray(edges))
    params = {}
    for aggrs in AGGRS:
        jnet = JaxNet(input_dim=1, hidden_dim=H, aggrs=aggrs, dropout=0.0)
        p = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(1),
                                               jdev.enc, jj))
        if aggrs == "lstm":
            p["params"]["aggr"]["bh"] = np.random.default_rng(9).normal(
                scale=0.2, size=p["params"]["aggr"]["bh"].shape).astype(
                np.float32)
        params[aggrs] = p
    port_sspg = encoders.ScalarSpG(nodes=sspg.nodes, values=sspg.values,
                                   sizes=sspg.sizes, seeds=sspg.seeds)
    return sspg, port_sspg, edges, jj, params


def test_gather_join_scalar_matches_jax(scalar_case):
    _, port_sspg, edges, jj, _ = scalar_case
    assert not edges.flags.c_contiguous
    dev = port_sspg.device("cpu")
    got = encoders.gather_join_scalar(dev.nodes, dev.eidx, dev.sizes,
                                      torch.as_tensor(edges))
    assert got.eidx.dtype == torch.float32
    np.testing.assert_array_equal(got.eidx.numpy(), np.asarray(jj.eidx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jj.mask))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(jj.sizes))
    cross = got.eidx[..., 1]
    assert bool((cross[~got.mask] == 0).all())
    # an absent partner's value is +0.0, the zero bit pattern
    assert bool((cross.view(torch.int32)[cross == 0] == 0).all())
    assert int((cross[got.mask] > 0).sum()) > 0
    with pytest.raises(ValueError):
        encoders.gather_join_scalar(dev.nodes, dev.eidx, dev.sizes,
                                    torch.zeros(3, 4, dtype=torch.int64))


def _port_net(params, aggrs, **kw):
    net = Net(1, H, aggrs=aggrs, dropout=0.0,
              key=prng.prng_key(0), device="cpu", **kw)
    net.load_state_dict(params_from_flax(params))
    return net


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("aggrs", AGGRS)
def test_scalar_net_matches_jax(scalar_case, aggrs, fused):
    """The port's Net over a scalar join against JAX's, route for route
    (JAX's fused lstm route serves through its kernel in Pallas interpret
    mode, the port's through K5's plain version)."""
    sspg, port_sspg, edges, jj, params = scalar_case
    jnet = JaxNet(input_dim=1, hidden_dim=H, aggrs=aggrs, dropout=0.0,
                  fused_hidden=fused)
    want = np.asarray(jnet.apply(params[aggrs], sspg.device().enc, jj))
    dev = port_sspg.device("cpu")
    joined = encoders.gather_join_scalar(dev.nodes, dev.eidx, dev.sizes,
                                         torch.as_tensor(edges))
    net = _port_net(params[aggrs], aggrs, fused_hidden=fused)
    with torch.no_grad():
        got = net.eval()(joined, enc_table=dev.enc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_scalar_predict_matches_jax(scalar_case, aggrs):
    sspg, port_sspg, _, _, params = scalar_case
    edges = np.random.default_rng(27).integers(0, N, size=(2, E)).astype(
        np.int32)
    jtr = JaxDeviceTrainer(JaxNet(input_dim=1, hidden_dim=H, aggrs=aggrs),
                           sspg.device(), JaxTrainConfig(batch_size=BS),
                           join_fn=jax_enc.gather_join_scalar)
    want = np.asarray(jtr.predict(params[aggrs], edges))
    tr = scalar_trainer_from_spg(_port_net(params[aggrs], aggrs), port_sspg,
                                 TrainConfig(batch_size=BS), device="cpu")
    got = tr.predict(edges)
    assert got.shape == (E,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_scalar_train_step_matches_jax(scalar_case, aggrs):
    """One training step's loss and gradients of the scalar trainer's
    route (fused lstm: JAX's folded scan, the port's K5 pair in plain
    versions; unfused mean and attn, the CPU default) against
    jax.value_and_grad of JAX's."""
    sspg, port_sspg, edges, jj, params = scalar_case
    fused = True if aggrs == "lstm" else None
    rng = np.random.default_rng(28)
    labels = (rng.random(edges.shape[1]) < 0.5).astype(np.float32)
    w = np.ones(edges.shape[1], np.float32)
    w[-3:] = 0.0                                   # padded ids weigh 0
    jnet = JaxNet(input_dim=1, hidden_dim=H, aggrs=aggrs, dropout=0.0,
                  fused_hidden=fused)
    enc = sspg.device().enc

    def loss_fn(p):
        logits = jnet.apply(p, enc, jj, train=True)
        per = optax.sigmoid_binary_cross_entropy(logits, labels)
        return (per * w).sum() / jnp.maximum(w.sum(), 1.0)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        params[aggrs])
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    net = _port_net(params[aggrs], aggrs, fused_hidden=fused)
    tr = scalar_trainer_from_spg(net, port_sspg, TrainConfig(batch_size=BS),
                                 device="cpu")
    joined, _ = tr._batch(torch.as_tensor(edges, dtype=torch.int64))
    loss = batch_loss(net.train()(joined, **tr.train_kw),
                      torch.as_tensor(labels), torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(got) == set(want)
    for name, gw in want.items():
        tol = dict(rtol=0, atol=1e-5) if name == GATE_BIAS else dict(
            rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[name], gw.numpy(), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_scalar_fit_matches_jax(scalar_case, aggrs):
    """JAX's DeviceTrainer.fit over the scalar sets for EPOCHS epochs
    against the port's from JAX's key (so JAX's riffle permutations),
    dropout 0."""
    sspg, port_sspg, _, _, _ = scalar_case
    fused = True if aggrs == "lstm" else None
    rng = np.random.default_rng(29)
    edges = rng.integers(0, N, size=(2, E)).astype(np.int32)
    labels = (rng.random(E) < 0.5).astype(np.float32)
    jtr = JaxDeviceTrainer(JaxNet(input_dim=1, hidden_dim=H, aggrs=aggrs,
                                  dropout=0.0, fused_hidden=fused),
                           sspg.device(), JaxTrainConfig(batch_size=BS,
                                                         lr=LR),
                           join_fn=jax_enc.gather_join_scalar)
    params0, opt_state = jtr.init(jax.random.PRNGKey(0), edges[:, :BS])
    key = jax.random.PRNGKey(5)
    params, _, losses, aucs = jtr.fit(params0, opt_state,
                                      jnp.asarray(edges),
                                      jnp.asarray(labels), key, EPOCHS)
    flat = lambda p: params_from_flax(jax.tree.map(np.asarray, p))
    state0, want = flat(params0), flat(params)
    net = Net(1, H, aggrs=aggrs, dropout=0.0, fused_hidden=fused,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(state0)
    tr = scalar_trainer_from_spg(net, port_sspg,
                                 TrainConfig(batch_size=BS, lr=LR),
                                 device="cpu")
    got_losses, got_aucs = tr.fit(edges, labels, EPOCHS, prng.as_key(key))
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=1e-5)
    np.testing.assert_allclose(got_aucs.numpy(), np.asarray(aucs),
                               atol=1e-6)
    moved = max(float(np.abs(want[k].numpy() - state0[k].numpy()).max())
                for k in want)
    assert moved > 3 * LR                    # the fit did train
    got = net.state_dict()
    for k, v in want.items():
        atol = 2 * LR * EPOCHS * -(-E // BS) if k == GATE_BIAS else 1e-5
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------ the CLI
SCALAR_CLI = {"host_spd": ["--engine", "host", "--sencoder", "SPD"],
              "device_ppr": ["--engine", "device", "--sencoder", "PPR"],
              "device_deg": ["--engine", "device", "--sencoder", "DEG"],
              "balanced_ppr": ["--engine", "device", "--sencoder", "PPR",
                               "--balance_widths", "4,8"]}


@pytest.mark.parametrize("case", sorted(SCALAR_CLI))
def test_scalar_cli_branches_on_the_cpu(tmp_path, case):
    """The CLI's scalar branches on both engines at a toy size: the
    trainer's sets are a ScalarSpG's (float values) with input_dim 1."""
    out = run_toy_cli(tmp_path, SCALAR_CLI[case])
    tr = out["trainer"]
    sets = tr.dev if hasattr(tr, "dev") else tr.sets
    assert torch.is_floating_point(sets.eidx)
    assert tr.model.pe_embedding.fc0.in_features == 1
