"""PyTorch port, hyperedge prediction: the hyperedge joins, HONet, its
training, the triplet datasets and the `main_horder` CLI, each against
the JAX package on the same inputs.

Tolerances, with their reasons:
- the joins (`make_keys_hjoin` in the lo-only, lead-in-hi and general
  layouts, on row-major and column-major hyperedges with repeated
  endpoints; `hgather_join`): every plane, mask, size and feature pair
  exactly (JAX's joins run eagerly: under jit XLA turns the feature
  scaling into a multiply by the reciprocal, 1 ulp away);
- HONet's logits: rtol 1e-5, atol 1e-6 (fp32 sums in other orders; the
  fused route recomputes the activations from the keys); parameter
  gradients within 1e-4 of each tensor's largest entry; the table
  trainer's scores rtol 1e-5, atol 1e-6;
- the two forms of the fused route's set sums (one Q=4 sum, and the
  route's two Q=2 sums over the cross plane's halves) and their
  gradients: within 1e-5 of the tensor's largest entry (the same fp32
  sums in another order, over up to 801 slots);
- one training step: loss rtol 1e-5, gradients rtol 1e-4, atol 1e-6; a
  2-epoch fit: parameters rtol 1e-4, atol 1e-5, losses rtol 1e-5, AUCs
  atol 1e-6, as tests/test_torch_port_train.py holds the Net's;
- `evaluate_device`'s MRR: within 1e-6 of JAX's when fed JAX's scores (a
  float32 mean in another order);
- the datasets and the CLI's data prep: exactly, numpy's global state
  after them too.
"""

import argparse
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surel_plus_tpu.graph import datasets as jds
from surel_plus_tpu.graph.splits import get_pos_neg_edges as jax_splits
from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import HONet as JaxHONet
from surel_plus_tpu.ops import join as jjoin
from surel_plus_tpu.ops.sampler import (
    sample_gsets_device as jax_sample_gsets_device,
)
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.ops.walk import enc_field_layout
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import DeviceTrainer as JaxDeviceTrainer
from surel_plus_tpu.train.device import evaluate_device as jax_evaluate
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.cli import main_horder as cli
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import datasets as tds
from surel_plus_tpu_torch.graph.splits import get_pos_neg_edges
from surel_plus_tpu_torch.models import HONet
from surel_plus_tpu_torch.models.honet import group_set_sums
from surel_plus_tpu_torch.ops import join as join_ops
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.kernels.hidden_sum import fused_key_hidden_sum
from surel_plus_tpu_torch.ops.merge_net import merge_pairs
from surel_plus_tpu_torch.spg import SpGDevice, SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import (
    DeviceTrainer,
    batch_loss,
    evaluate_device,
    trainer_from_keys,
)
from surel_plus_tpu_torch.utils import config as tconfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = os.path.join(ROOT, "surel_plus_tpu", "data", "fixtures",
                    "tags_fixture.npz")
N, H, NQ = 120, 16, 16
# (num_walks, num_steps): lo-only at two widths, lead-in-hi (the root bit
# in the hi word, root planes), the general hi/lo layout (no key planes)
LAYOUTS = {"lo_only_m50": (50, 2), "lo_only": (100, 3),
           "lead_in_hi": (200, 4), "general": (1000, 4)}
CPU = torch.device("cpu")


def _c(x):
    """A JAX array -> a torch tensor with the same bits (uint32 as int32)."""
    x = np.array(x)
    return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)


def _hedges(seed, n=NQ):
    """[3, n] hyperedges, column-major (the CLI's layout: a concatenation
    of transposed [E, 3] arrays), with repeated endpoints: u = w, v = w,
    u = v = w, u = v."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, N, size=(n, 3)).astype(np.int32)
    tri[0, 2] = tri[0, 0]
    tri[1, 2] = tri[1, 1]
    tri[2, :] = tri[2, 0]
    tri[3, 1] = tri[3, 0]
    half = n // 2
    he = np.concatenate([tri[:half].T, tri[half:].T], axis=1)
    assert not he.flags.c_contiguous
    return he


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def sampled(request):
    """JAX-sampled sets in one layout, carried to torch. The general
    layout's sets are bucketed to N slots (M S' + 1 = 4001 otherwise); the
    lead-in-hi ones keep their L = 801 on a small batch."""
    nw, ns = LAYOUTS[request.param]
    g = jax_rmat_graph(N, 500, seed=51)
    spgk = sample_gsets_device_keys(
        g, np.arange(N, dtype=np.int32), num_walks=nw, num_steps=ns,
        seed=7, block_size=64,
        bucket=N if request.param == "general" else None)
    tspgk = SpGKeys(nodes=_c(spgk.nodes), khi=_c(spgk.khi),
                    klo=_c(spgk.klo), sizes=_c(spgk.sizes), num_walks=nw,
                    num_steps=ns)
    return request.param, nw, ns, spgk, tspgk


def _jrows(spgk):
    return spgk.nodes, spgk.khi, spgk.klo, spgk.sizes


def _trows(tspgk):
    return tspgk.nodes, tspgk.khi, tspgk.klo, tspgk.sizes


def _assert_joins_equal(got, want, what):
    for name in got._fields:
        t, w = getattr(got, name), getattr(want, name)
        assert (t is None) == (w is None), f"{what} {name}"
        if t is not None:
            w = np.asarray(w)
            w = w.view(np.int32) if w.dtype == np.uint32 else w
            assert t.shape == w.shape, f"{what} {name}"
            np.testing.assert_array_equal(t.numpy(), w,
                                          err_msg=f"{what} {name}")


# ------------------------------------------------------------ the joins
def test_hjoin_matches_jax(sampled, monkeypatch):
    """make_keys_hjoin against JAX's, eagerly, on column-major hyperedges
    with repeated endpoints: every field exactly; the merges take
    contiguous rows; `features=False` keeps the planes, drops the pairs."""
    name, nw, ns, spgk, tspgk = sampled
    he = _hedges(52)
    want = jjoin.make_keys_hjoin(nw, ns)(*_jrows(spgk), jnp.asarray(he))
    contiguous = []

    def merge(*args):
        contiguous.append(all(a.is_contiguous() for a in args))
        return merge_pairs(*args)

    monkeypatch.setattr(join_ops, "merge_pairs", merge)
    edges = torch.as_tensor(he, dtype=torch.int64)
    assert not edges.is_contiguous()
    got = join_ops.make_keys_hjoin(nw, ns)(*_trows(tspgk), edges)
    _assert_joins_equal(got, want, name)
    assert len(contiguous) == 2 and all(contiguous)
    lead = enc_field_layout(nw, ns)[2]
    assert (got.kown is None) == (lead > 32)
    assert (got.kown_root is None) == (lead != 32)
    assert bool((got.eidx[..., 1, :] != 0).any())      # partners found
    if got.kown is not None:
        bare = join_ops.make_keys_hjoin(nw, ns, features=False)(
            *_trows(tspgk), edges)
        assert bare.eidx is None
        for f in ("mask", "sizes", "kown", "kcross", "kcross_mask",
                  "kown_root", "kcross_root"):
            x, y = getattr(bare, f), getattr(got, f)
            assert (x is None and y is None) or torch.equal(x, y), f


def test_hjoin_gathered_rows_match_jax(sampled):
    """join_gathered_hkeys (the pre-gathered form) on rows of repeated and
    identical endpoints equals JAX's join of the same hyperedges (JAX's
    make_keys_hjoin is its join_gathered_hkeys on the gathered rows)."""
    name, nw, ns, spgk, tspgk = sampled
    he = _hedges(52)
    want = jjoin.make_keys_hjoin(nw, ns)(*_jrows(spgk), jnp.asarray(he))
    rows = torch.as_tensor(np.ascontiguousarray(he), dtype=torch.int64)
    got = join_ops.join_gathered_hkeys(*(x[rows] for x in _trows(tspgk)),
                                       nw, ns)
    _assert_joins_equal(got, want, name)


@pytest.fixture(scope="module")
def table_sets():
    g = jax_rmat_graph(N, 500, seed=54)
    jdev, _ = jax_sample_gsets_device(g, np.arange(N, dtype=np.int32),
                                      num_walks=16, num_steps=3, seed=9,
                                      block_size=32)
    tdev = SpGDevice(nodes=_c(jdev.nodes), eidx=_c(jdev.eidx),
                     sizes=_c(jdev.sizes), enc=_c(jdev.enc))
    return jdev, tdev


def test_hgather_join_matches_jax(table_sets):
    jdev, tdev = table_sets
    he = _hedges(55)
    want = jjoin.hgather_join(jdev.nodes, jdev.eidx, jdev.sizes,
                              jnp.asarray(he))
    got = join_ops.hgather_join(tdev.nodes, tdev.eidx, tdev.sizes,
                                torch.as_tensor(he))
    _assert_joins_equal(got, want, "hgather_join")
    assert bool((got.eidx[..., 1] != 0).any())


def test_link_joins_refuse_hyperedges(sampled, table_sets):
    """A [3, B] query given to a link join raises instead of joining two
    of its rows; the message points to the hyperedge joins."""
    name, nw, ns, spgk, tspgk = sampled
    _, tdev = table_sets
    he = torch.as_tensor(_hedges(56))
    with pytest.raises(ValueError, match="make_keys_hjoin"):
        join_ops.make_keys_join(nw, ns)(*_trows(tspgk), he)
    with pytest.raises(ValueError, match="hgather_join"):
        join_ops.gather_join(tdev.nodes, tdev.eidx, tdev.sizes, he)
    with pytest.raises(ValueError, match="hyperedges"):
        join_ops.make_keys_hjoin(nw, ns)(*_trows(tspgk), he[:2])


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def model_case():
    """Lo-only sets (M=8, S'=3), a JAX hjoin of 24 hyperedges, JAX HONet's
    weights (the biases nonzero) and the port's joins of the same batch."""
    nw, ns = 8, 3
    g = jax_rmat_graph(300, 2400, seed=4)
    spgk = sample_gsets_device_keys(g, np.arange(300, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=4,
                                    block_size=300)
    tspgk = SpGKeys(nodes=_c(spgk.nodes), khi=_c(spgk.khi),
                    klo=_c(spgk.klo), sizes=_c(spgk.sizes), num_walks=nw,
                    num_steps=ns)
    he = np.random.default_rng(11).integers(0, 300, size=(3, 24)).astype(
        np.int32)
    jj = jjoin.make_keys_hjoin(nw, ns)(*_jrows(spgk), jnp.asarray(he))
    enc = jnp.zeros((1, 1), jnp.float32)
    params = jax.tree.map(np.asarray, JaxHONet(
        input_dim=ns + 1, hidden_dim=H, dropout=0.0, fused_hidden=False
    ).init(jax.random.PRNGKey(0), enc, jj))
    rng = np.random.default_rng(12)
    for mod in ("pe_embedding", "affinity_score"):
        for dense in params["params"][mod].values():
            dense["bias"] = rng.normal(scale=0.2, size=dense["bias"].shape
                                       ).astype(np.float32)
    tj = join_ops.make_keys_hjoin(nw, ns)(*_trows(tspgk),
                                          torch.as_tensor(he))
    return nw, ns, jj, enc, params, tj


def _port_honet(params, fused, nw, ns):
    net = HONet(ns + 1, H, dropout=0.0, fused_hidden=fused,
                key_layout=(nw, ns), key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(params))
    return net


def test_params_from_flax_maps_honet(model_case):
    *_, params, _ = model_case
    state = params_from_flax(params)
    net = HONet(4, H, key=prng.prng_key(0), device="cpu")
    assert set(state) == set(net.state_dict())
    assert state["affinity_score.fc0.weight"].shape == (H, 4 * H)
    net.load_state_dict(state)


def _jax_loss_grads(model, params, enc, jj):
    def loss(p):
        return (model.apply(p, enc, jj) ** 2).sum()

    logits = np.asarray(model.apply(params, enc, jj))
    grads = params_from_flax(jax.tree.map(np.asarray,
                                          jax.grad(loss)(params)))
    return logits, grads


def _port_loss_grads(net, tj, **kw):
    logits = net(tj, **kw)
    (logits ** 2).sum().backward()
    return logits.detach().numpy(), {n: p.grad for n, p in
                                     net.named_parameters()}


def _assert_close(got, want):
    logits, grads = got
    wl, wg = want
    np.testing.assert_allclose(logits, wl, rtol=1e-5, atol=1e-6)
    assert set(grads) == set(wg)
    for k, w in wg.items():
        err = float((grads[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (k, err)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_honet_routes_match_jax(model_case, route):
    """The port's fused route (K1's plain pair over the key planes) and its
    unfused route (feature pairs) against JAX's unfused HONet: logits and
    parameter gradients."""
    nw, ns, jj, enc, params, tj = model_case
    want = _jax_loss_grads(JaxHONet(input_dim=ns + 1, hidden_dim=H,
                                    dropout=0.0, fused_hidden=False),
                           params, enc, jj)
    net = _port_honet(params, route == "fused", nw, ns)
    _assert_close(_port_loss_grads(net, tj), want)


def test_honet_fused_matches_jax_fused_interpret(model_case):
    """The fused route against JAX's fused HONet, whose two q=2 Pallas
    calls run in interpret mode on the CPU."""
    nw, ns, jj, enc, params, tj = model_case
    want = _jax_loss_grads(JaxHONet(input_dim=ns + 1, hidden_dim=H,
                                    dropout=0.0, fused_hidden=True,
                                    key_layout=(nw, ns)),
                           params, enc, jj)
    net = _port_honet(params, True, nw, ns)
    _assert_close(_port_loss_grads(net, tj), want)


def test_set_sum_forms_agree(sampled):
    """One Q=4 sum over the [B, 4L] plane and the route's two Q=2 sums over
    its halves (`group_set_sums`) give the same sums and the same
    gradient. A join without key planes (the general layout) sends the
    fused HONet to its feature pairs: the same logits as the unfused
    route."""
    name, nw, ns, spgk, tspgk = sampled
    edges = torch.as_tensor(_hedges(57))
    net = HONet(ns + 1, H, key_layout=(nw, ns), device="cpu",
                key=prng.prng_key(3))
    if name == "general":
        tj = join_ops.make_keys_hjoin(nw, ns, features=False)(
            *_trows(tspgk), edges)
        assert tj.kown is None and tj.eidx is not None
        net.fused_hidden = True
        fused = net.eval()(tj)
        net.fused_hidden = False
        torch.testing.assert_close(fused, net(tj), rtol=0, atol=0)
        return
    tj = join_ops.make_keys_hjoin(nw, ns, features=False)(
        *_trows(tspgk), edges)
    shift = int(nw).bit_length()
    g = torch.randn(4, NQ, H, generator=torch.Generator().manual_seed(4))
    out = []
    for sums in (lambda u: fused_key_hidden_sum(
                     tj.kown, tj.mask, tj.kcross, tj.kcross_mask, u, shift,
                     root_own=tj.kown_root, root_cross=tj.kcross_root),
                 lambda u: group_set_sums(tj, u, shift)):
        u = net._u_ext().detach().requires_grad_()
        s = sums(u)
        (s * g).sum().backward()
        out.append((s.detach(), u.grad))
    (s1, d1), (s2, d2) = out
    assert s1.shape == (4, NQ, H) and bool((s1 != 0).any())
    for got, want in ((s2, s1), (d2, d1)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_k1_takes_the_halves_as_row_strided_views():
    """K1's wrappers read the cross planes with one row stride (ldc):
    contiguous planes give ldc = Lc, HONet's halves of a [B, 4L] plane
    ldc = 4L (views, read in place, a plane of masks B ldc apart); any
    other layout raises before a launch."""
    from surel_plus_tpu_torch.ops.kernels.hidden_sum import (
        _cross_row_stride as ldc)

    b, ell = 5, 7
    k = torch.zeros(b, 4 * ell, dtype=torch.int32)
    m = torch.zeros(4, b, 4 * ell, dtype=torch.bool)
    assert ldc(k, m, k) == 4 * ell
    for g, c in ((slice(0, 2), slice(0, 2 * ell)),
                 (slice(2, 4), slice(2 * ell, 4 * ell))):
        assert ldc(k[:, c], m[g, :, c], k[:, c]) == 4 * ell
        assert ldc(k[:1, c], m[g, :1, c], None) == b * 4 * ell
    assert ldc(k[:1, :3], m[:1, :1, :3], None) == 3
    bad = [(k[:, ::2], m[:, :, ::2], None),
           (k[:, :ell], m[:2, :, :ell].contiguous(), None),
           (k[:, :ell].contiguous(), m[:2, :, :ell], None),
           (k[:, :ell], m[:2, :, :ell], k[:, :ell].contiguous())]
    for args in bad:
        with pytest.raises(ValueError, match="same stride"):
            ldc(*args)


@pytest.mark.parametrize("embed_mode", ["table", "direct"])
def test_honet_table_route_matches_jax(table_sets, embed_mode):
    """HONet over an encoding-table join (hgather_join) with the table,
    both embed modes, against JAX's HONet on JAX's join."""
    jdev, tdev = table_sets
    he = _hedges(58)
    jj = jjoin.hgather_join(jdev.nodes, jdev.eidx, jdev.sizes,
                            jnp.asarray(he))
    jnet = JaxHONet(input_dim=4, hidden_dim=H, dropout=0.0)
    params = jax.tree.map(np.asarray,
                          jnet.init(jax.random.PRNGKey(2), jdev.enc, jj))
    want = _jax_loss_grads(jnet, params, jdev.enc, jj)
    tj = join_ops.hgather_join(tdev.nodes, tdev.eidx, tdev.sizes,
                               torch.as_tensor(he))
    net = HONet(4, H, dropout=0.0, key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(params))
    _assert_close(_port_loss_grads(net, tj, enc_table=tdev.enc,
                                   embed_mode=embed_mode), want)


def test_table_trainer_matches_jax(table_sets):
    """DeviceTrainer(HONet, SpGDevice, cfg, join=hgather_join): predict
    against JAX's table trainer with the same weights (rtol 1e-5, atol
    1e-6), and a training epoch (the "direct" embed mode) runs."""
    jdev, tdev = table_sets
    he = _hedges(59, n=20)
    jtr = JaxDeviceTrainer(JaxHONet(input_dim=4, hidden_dim=H, dropout=0.0),
                           jdev, JaxTrainConfig(batch_size=8),
                           join_fn=jjoin.hgather_join)
    params, _ = jtr.init(jax.random.PRNGKey(3), he[:, :8])
    want = np.asarray(jtr.predict(params, he))
    net = HONet(4, H, dropout=0.0, key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tr = DeviceTrainer(net, tdev, TrainConfig(batch_size=8),
                       join=join_ops.hgather_join)
    got = tr.predict(he)
    assert got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    losses, aucs = tr.fit(he, torch.ones(20), 1, prng.prng_key(0))
    assert bool(torch.isfinite(losses).all()) and aucs.shape == (1,)


def test_honet_raises_on_what_it_cannot_read(model_case):
    nw, ns, jj, enc, params, tj = model_case
    net = _port_honet(params, False, nw, ns)
    with pytest.raises(ValueError, match="feature pairs"):
        net(tj._replace(eidx=None))
    with pytest.raises(ValueError, match="raw node features"):
        net(tj, torch.zeros(3, NQ, 2))
    net = HONet(ns + 1, H, fused_hidden=True,
                key=prng.prng_key(0), device="cpu")
    with pytest.raises(ValueError, match="key_layout"):
        net(tj)
    assert net.join_outputs(CPU) == {"features": False}
    assert HONet(ns + 1, H,
                 key=prng.prng_key(0), device="cpu").join_outputs(CPU) == {
        "features": True}


# ------------------------------------------------------------ training
@pytest.fixture(scope="module")
def train_case(model_case):
    """The JAX trainer's 2-epoch fit of an unfused HONet (dropout 0) over
    21 hyperedges in batches of 8 from the key PRNGKey(5), its
    parameters before and after."""
    nw, ns = 8, 3
    g = jax_rmat_graph(300, 2400, seed=4)
    spgk = sample_gsets_device_keys(g, np.arange(300, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=4,
                                    block_size=300)
    rng = np.random.default_rng(13)
    edges = np.concatenate([rng.integers(0, 300, size=(11, 3)).T,
                            rng.integers(0, 300, size=(10, 3)).T],
                           axis=1).astype(np.int32)
    labels = (rng.random(21) < 0.5).astype(np.float32)
    jtr = jax_trainer(JaxHONet(input_dim=ns + 1, hidden_dim=H, dropout=0.0),
                      spgk, JaxTrainConfig(batch_size=8, lr=1e-2),
                      join_factory=jjoin.make_keys_hjoin)
    p0, opt = jtr.init(jax.random.PRNGKey(0), edges[:, :8])
    key = jax.random.PRNGKey(5)
    p1, _, losses, aucs = jtr.fit(p0, opt, jnp.asarray(edges),
                                  jnp.asarray(labels), key, 2)
    flat = lambda p: params_from_flax(jax.tree.map(np.asarray, p))
    tspgk = SpGKeys(nodes=_c(spgk.nodes), khi=_c(spgk.khi),
                    klo=_c(spgk.klo), sizes=_c(spgk.sizes), num_walks=nw,
                    num_steps=ns)
    return (tspgk, edges, labels, jax.tree.map(np.asarray, p0), flat(p1),
            np.asarray(losses), np.asarray(aucs), prng.as_key(key))


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_train_step_matches_jax(model_case, route):
    """One step's loss and parameter gradients against
    jax.value_and_grad of JAX's (its unfused route), labels random, the
    last 3 queries weighing 0."""
    nw, ns, jj, enc, params, tj = model_case
    rng = np.random.default_rng(14)
    labels = (rng.random(24) < 0.5).astype(np.float32)
    w = np.ones(24, np.float32)
    w[-3:] = 0.0
    jnet = JaxHONet(input_dim=ns + 1, hidden_dim=H, dropout=0.0,
                    fused_hidden=False)

    def loss_fn(p):
        per = optax.sigmoid_binary_cross_entropy(
            jnet.apply(p, enc, jj, train=True), labels)
        return (per * w).sum() / jnp.maximum(w.sum(), 1.0)

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = params_from_flax(jax.tree.map(np.asarray, want))
    net = _port_honet(params, route == "fused", nw, ns)
    loss = batch_loss(net.train()(tj), torch.as_tensor(labels),
                      torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_fit_matches_jax(train_case, route):
    """trainer_from_keys(HONet, ..., join_factory=make_keys_hjoin).fit over
    2 epochs against JAX's from JAX's key (so JAX's batch order), on
    column-major hyperedges; then predict and evaluate_device run on
    [3, E] splits."""
    tspgk, edges, labels, p0, want, losses, aucs, key = train_case
    net = HONet(4, H, dropout=0.0, fused_hidden=route == "fused",
                key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(p0))
    tr = trainer_from_keys(net, tspgk, TrainConfig(batch_size=8, lr=1e-2),
                           join_factory=join_ops.make_keys_hjoin)
    assert net.key_layout == (8, 3)
    got_losses, got_aucs = tr.fit(edges, labels, 2, key)
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=1e-5)
    np.testing.assert_allclose(got_aucs.numpy(), aucs, atol=1e-6)
    state0 = params_from_flax(p0)
    moved = max(float((want[k] - state0[k]).abs().max()) for k in want)
    assert moved > 3e-2                               # the fit did train
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    scores = tr.predict(edges)
    assert scores.shape == (21,) and bool(torch.isfinite(scores).all())


class _Fixed:
    """A stand-in trainer whose predict returns given scores."""

    def __init__(self, scores):
        self.scores = scores

    def predict(self, edges):
        return self.scores[np.asarray(edges).tobytes()]


def test_evaluate_device_mrr_matches_jax(model_case):
    """MRR on [3, E] splits (k = 7 negatives a positive): fed JAX's scores
    of the JAX trainer, within 1e-6 of JAX's evaluate_device."""
    nw, ns = 8, 3
    g = jax_rmat_graph(300, 2400, seed=4)
    spgk = sample_gsets_device_keys(g, np.arange(300, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=4,
                                    block_size=300)
    jtr = jax_trainer(JaxHONet(input_dim=ns + 1, hidden_dim=H, dropout=0.0),
                      spgk, JaxTrainConfig(batch_size=32),
                      join_factory=jjoin.make_keys_hjoin)
    params, _ = jtr.init(jax.random.PRNGKey(1),
                         np.zeros((3, 32), np.int32))
    rng = np.random.default_rng(15)
    inf, scores = {}, {}
    for split, npos in (("valid", 20), ("test", 30)):
        pos = rng.integers(0, 300, size=(3, npos)).astype(np.int32)
        neg = np.concatenate([np.repeat(pos[:2], 7, axis=1),
                              rng.integers(0, 300, (1, npos * 7))]
                             ).astype(np.int32)
        inf[split] = (pos, neg)
        for e in (pos, neg):
            scores[e.tobytes()] = torch.tensor(np.asarray(
                jtr.predict(params, e)))
    want, _ = jax_evaluate(jtr, params, inf, "MRR")
    got, t_test = evaluate_device(_Fixed(scores), inf, "MRR")
    assert t_test >= 0 and got[0] == 0
    for i in (1, 2):
        assert abs(got[i] - want[i]) <= 1e-6


# ------------------------------------------------------------ the data
def _global_draw():
    return np.random.randint(1 << 30, size=4)


def test_make_edge_split_matches_jax():
    tuples = np.random.default_rng(16).integers(0, 400, size=(500, 3))
    got = tds.DEHyperDataset.make_edge_split(tuples, ratio=0.6, k=9,
                                             seed=17)
    after = _global_draw()
    want = jds.DEHyperDataset.make_edge_split(tuples, ratio=0.6, k=9,
                                              seed=17)
    np.testing.assert_array_equal(after, _global_draw())
    assert set(got) == set(want) == {"train", "valid", "test"}
    for split, d in want.items():
        assert set(got[split]) == set(d)
        for key, v in d.items():
            np.testing.assert_array_equal(got[split][key], v)


def _assert_datasets_equal(got, want, logger):
    assert (got.num_nodes, got.k, got.num_feature) == (
        want.num_nodes, want.k, want.num_feature)
    np.testing.assert_array_equal(got.obsrv_edge, want.obsrv_edge)
    g_got, g_want = got.process(logger), want.process(logger)
    np.testing.assert_array_equal(got.pos_hedge, want.pos_hedge)
    np.testing.assert_array_equal(got.neg_hedge, want.neg_hedge)
    assert g_got.num_nodes == g_want.num_nodes
    np.testing.assert_array_equal(g_got.indptr, g_want.indptr)
    np.testing.assert_array_equal(g_got.indices, g_want.indices)
    assert (g_got.data is None) == (g_want.data is None)
    if g_want.data is not None:
        np.testing.assert_array_equal(g_got.data, g_want.data)


def test_synthetic_hyper_data_matches_jax(caplog):
    got = tds.synthetic_hyper_data(num_nodes=300, num_triplets=900, seed=3)
    after = _global_draw()
    want = jds.synthetic_hyper_data(num_nodes=300, num_triplets=900, seed=3)
    np.testing.assert_array_equal(after, _global_draw())
    for split in ("train", "valid", "test"):
        for key, v in want.split_edge[split].items():
            np.testing.assert_array_equal(got.split_edge[split][key], v)
    _assert_datasets_equal(got, want, None)


def test_from_npz_matches_jax_on_the_tags_fixture():
    got = tds.DEHyperDataset.from_npz(TAGS, k=10)
    want = jds.DEHyperDataset.from_npz(TAGS, k=10)
    assert got.num_nodes == 5000 and len(got.obsrv_edge) == 120_000
    for split in ("train", "valid", "test"):
        for key, v in want.split_edge[split].items():
            np.testing.assert_array_equal(got.split_edge[split][key], v)
    _assert_datasets_equal(got, want, None)
    assert got.neg_hedge.shape == (240_000, 3)


@pytest.mark.parametrize("valid_perc", [100, 25])
def test_cli_data_prep_matches_jax(valid_perc):
    """The CLI's data prep in the JAX CLI's order: the dataset, its
    negatives, the training hyperedges and labels, the valid (subsampled
    at valid_perc) and test splits, and numpy's global state after."""
    out = []
    for pkg, splits in ((tds, get_pos_neg_edges), (jds, jax_splits)):
        np.random.seed(0)
        ds = pkg.DEHyperDataset.from_npz(TAGS, k=10)
        ds.process(None)
        val = splits("valid", ds.split_edge, None, ds.num_nodes,
                     percent=valid_perc)
        test = splits("test", ds.split_edge, None, ds.num_nodes)
        out.append((ds.pos_hedge.T.astype(np.int32),
                    ds.neg_hedge.T.astype(np.int32), val, test,
                    _global_draw()))
    (pos, neg, val, test, after), (wpos, wneg, wval, wtest, wafter) = out
    np.testing.assert_array_equal(pos, wpos)
    np.testing.assert_array_equal(neg, wneg)
    for a, b in zip(val + test, wval + wtest):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert val[0].shape == (3, 8000 * valid_perc // 100)
    assert val[1].shape[1] == 50 * val[0].shape[1]
    np.testing.assert_array_equal(after, wafter)


# ------------------------------------------------------------ the CLI
# the device engine, which `--engine auto` takes on the card
TOY = ["--engine", "device", "--synth_nodes", "300", "--synth_edges", "400",
       "--num_walks", "10",
       "--num_steps", "3", "--epochs", "4", "--eval_steps", "2",
       "--batch_size", "512"]


def _config(argv):
    parser = argparse.ArgumentParser()
    tconfig.add_config_args(parser)
    return tconfig.config_from_args(parser.parse_args(argv))


def _summarizer():
    spec = importlib.util.spec_from_file_location(
        "summarize_fixture_results",
        os.path.join(ROOT, "scripts", "summarize_fixture_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_npz(path):
    """A hypergraph npz export of a synthetic dataset (from_npz's keys)."""
    ds = tds.synthetic_hyper_data(num_nodes=300, num_triplets=500, seed=5)
    s = ds.split_edge
    np.savez(path, num_nodes=ds.num_nodes, edge_index=ds.obsrv_edge,
             train_hedge=s["train"]["hedge"], valid_hedge=s["valid"]["hedge"],
             test_hedge=s["test"]["hedge"], valid_neg=s["valid"]["hedge_neg"],
             test_neg=s["test"]["hedge_neg"])
    return f"npz:{path}"


@pytest.mark.parametrize("dataset,runs", [("synth-tags", 2), ("npz", 1)])
def test_run_experiment_on_the_cpu(tmp_path, dataset, runs):
    """Epoch 0 alone, then blocks of eval_steps epochs, the last one
    shorter (epochs 1-2, then 3): three evaluations a run, an MRR in
    [0, 1] each."""
    if dataset == "npz":
        dataset = _small_npz(tmp_path / "hyper.npz")
    cfg = _config(["--dataset", dataset, "--runs", str(runs), "--log_dir",
                   str(tmp_path / "logs"), "--valid_perc", "50", *TOY])
    out = cli.run_experiment(cfg, device="cpu")
    assert cfg.metric == "MRR" and len(out["best"]) == runs
    for pair in out["best"]:
        assert all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in pair)
    evals = out["results"].results
    assert [len(evals[r]) for r in range(runs)] == [3] * runs
    assert out["edges"].shape[0] == 3
    assert isinstance(out["trainer"].model, HONet)


def test_main_on_the_cpu_writes_a_summarizable_log(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("SUREL_PLATFORM", "cpu")
    cli.main(["--dataset", "synth-tags", "--log_dir", str(tmp_path), *TOY])
    best = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(best) == 1 and len(best[0]) == 2
    (log_file,) = (tmp_path / "synth-tags").glob("*.log")
    parsed = _summarizer().parse(str(log_file))
    assert list(parsed) == ["MRR"] and parsed["MRR"][0].shape == (3, 2)
    text = log_file.read_text()
    assert "Run: 01, Epoch: 03, Loss:" in text and "eval MRR:" in text
    assert "phase train_epoch" in text and "hypergraph:" in text
    assert "phase load" in text


def test_main_without_a_device_raises(monkeypatch):
    monkeypatch.delenv("SUREL_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SUREL_PLATFORM=cpu"):
        cli.main(["--dataset", "synth-tags", *TOY])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_experiment(_config(["--dataset", "synth-tags"]))


@pytest.mark.parametrize("extra", [["--resume", "ckpt"]], ids=["resume"])
def test_unported_options_raise(tmp_path, extra):
    """--resume is ignored, as the JAX package's main_horder ignores it:
    the run equals the run without the flag."""
    runs = [cli.run_experiment(_config(
        ["--dataset", "synth-tags", *TOY, "--log_dir",
         str(tmp_path / str(i)), *flags]), device="cpu")
        for i, flags in enumerate(([], extra))]
    assert runs[1]["best"] == runs[0]["best"]
    for k, v in runs[0]["trainer"].model.state_dict().items():
        assert torch.equal(runs[1]["trainer"].model.state_dict()[k], v), k
