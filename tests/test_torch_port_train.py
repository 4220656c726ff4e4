"""PyTorch port, the training slice: one step's loss and gradients, the
optimizer, the epoch metrics and a short fit, each against the JAX
package on the same inputs, in float32 with dropout 0, for the mean, the
attention and the LSTM aggregators.

Tolerances, with their reasons:
- loss and gradients of one step: rtol 1e-4, atol 1e-6 (fp32 sums over
  the sets in other orders; the fused routes recompute the activations
  from the keys);
- clip and Adam: rtol 1e-6, atol 1e-9 (the same float32 formula,
  rounded at other points: torch's Adam divides by sqrt(v)/sqrt(1-b2^t)
  + eps where optax divides by sqrt(v/(1-b2^t)) + eps);
- the fit: parameters rtol 1e-4, atol 1e-5. An Adam step moves a
  parameter by about lr times the sign of its gradient whatever the
  gradient's size, so a gradient that is rounding noise could move a
  parameter by 2 lr the other way; with these seeds none is, and the
  fit's parameters agree to about 1e-6. Losses rtol 1e-5; histogram AUCs
  atol 1e-6 (a score a rounding away from a bin edge would change it by
  a whole pair);
- metrics on tied scores: histograms exactly, AUCs to float32 rounding;
- the attention gate's bias (`aggr.gate_nn.bias`): its gradient is 0 in
  exact arithmetic (a shift of every gate of a set leaves the softmax as
  it is), so both frameworks give rounding noise there, held to atol 1e-5
  alone as JAX's own test holds it (tests/test_pallas_hidden_sum.py:
  488-490). Adam turns that noise into steps of up to about lr either
  way, and the bias does not change the function, so after a fit it is
  held to 2 lr per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import device_auc as jax_device_auc
from surel_plus_tpu.train.device import device_auc_hist as jax_auc_hist
from surel_plus_tpu.train.device import riffle_permutation as jax_riffle
from surel_plus_tpu.train.device import score_histogram as jax_histogram
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import make_keys_join
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import (
    batch_loss,
    clip_by_global_norm_,
    device_auc,
    device_auc_hist,
    riffle_permutation,
    score_histogram,
    trainer_from_keys,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, N, BS, E, EPOCHS, LR = 16, 120, 8, 21, 2, 1e-2   # E % BS != 0
LAYOUTS = {"lo_only": (100, 3), "lead_in_hi": (200, 4)}
ROUTES = {"fused": True, "unfused": False}
AGGRS = ("attn", "lstm", "mean")
GATE_BIAS = "aggr.gate_nn.bias"   # gradient 0 up to rounding (see above)


def _c(x):
    return torch.as_tensor(np.array(x).view(np.int32))


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def sampled(request):
    nw, ns = LAYOUTS[request.param]
    g = rmat_graph(N, 600, seed=31)
    spgk = sample_gsets_device_keys(g, np.arange(N, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=6,
                                    block_size=64)
    tspgk = SpGKeys(nodes=_c(spgk.nodes), khi=_c(spgk.khi),
                    klo=_c(spgk.klo), sizes=_c(spgk.sizes), num_walks=nw,
                    num_steps=ns)
    return nw, ns, spgk, tspgk


def _grads_by_name(net):
    return {n: p.grad.numpy() for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def step_batch(sampled):
    """One training batch of 16 queries (the last 3 padded, weight 0),
    JAX's join of it, and each aggregator's initial JAX parameters. Both
    routes share them: the JAX Net's parameters do not depend on its
    route (the same tree from the same key), so one init (on the unfused
    route) serves both."""
    nw, ns, spgk, tspgk = sampled
    rng = np.random.default_rng(32)
    edges = rng.integers(0, N, size=(2, 16)).astype(np.int32)
    labels = (rng.random(16) < 0.5).astype(np.float32)
    w = np.ones(16, np.float32)
    w[-3:] = 0.0                                   # padded ids weigh 0
    jj = jax.jit(jax_make_keys_join(nw, ns))(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes, jnp.asarray(edges))
    enc = jnp.zeros((1, 1), jnp.float32)
    params = {a: JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs=a,
                        dropout=0.0, key_layout=(nw, ns),
                        fused_hidden=False).init(jax.random.PRNGKey(4),
                                                 enc, jj)
              for a in AGGRS}
    return edges, labels, w, jj, enc, params


@pytest.mark.parametrize("aggrs", AGGRS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_step_loss_and_grads_match_jax(sampled, step_batch, route,
                                             aggrs):
    nw, ns, spgk, tspgk = sampled
    edges, labels, w, jj, enc, params = step_batch
    params = params[aggrs]
    fused = ROUTES[route]
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs=aggrs, dropout=0.0,
                  key_layout=(nw, ns), fused_hidden=fused)

    def loss_fn(p):
        logits = jnet.apply(p, enc, jj, train=True)
        per = optax.sigmoid_binary_cross_entropy(logits, labels)
        return (per * w).sum() / jnp.maximum(w.sum(), 1.0)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))

    net = Net(ns + 1, H, aggrs=aggrs, dropout=0.0, key_layout=(nw, ns),
              fused_hidden=fused, key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tj = make_keys_join(nw, ns, **net.join_outputs(torch.device("cpu")))(
        tspgk.nodes, tspgk.khi, tspgk.klo, tspgk.sizes,
        torch.as_tensor(edges))
    loss = batch_loss(net.train()(tj), torch.as_tensor(labels),
                      torch.as_tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = _grads_by_name(net)
    assert set(got) == set(want)
    for name, gw in want.items():
        if name == GATE_BIAS:
            np.testing.assert_allclose(got[name], gw.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], gw.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def _tree(rng, scale):
    return {"a": (rng.normal(size=(5, 3)) * scale).astype(np.float32),
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_matches_optax(scale):
    g = _tree(np.random.default_rng(8), scale)
    norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                       for x in g.values()))
    assert (norm < 1.0) == (scale < 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        jax.tree.map(jnp.asarray, g), optax.EmptyState())
    got = {k: torch.as_tensor(v.copy()) for k, v in g.items()}
    clip_by_global_norm_(list(got.values()), 1.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)
    if scale < 1.0:
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(), g[k])


@pytest.mark.parametrize("steps", [1, 3])
def test_clip_adam_matches_optax(steps):
    """The trainer's optimizer (clip, then torch.optim.Adam as the trainer
    builds it) against optax.chain(clip_by_global_norm, adam)."""
    rng = np.random.default_rng(9)
    p0 = _tree(rng, 1.0)
    grads = [_tree(rng, s) for s in (0.02, 3.0, 0.5)[:steps]]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
          for k, v in p0.items()}
    topt = torch.optim.Adam(list(tp.values()), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.as_tensor(g[k].copy())
        clip_by_global_norm_([v.grad for v in tp.values()], 1.0)
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("rows,cols", [(1, 7), (5, 8), (33, 4), (6, 6)])
def test_riffle_permutation_is_a_permutation(rows, cols):
    perm = riffle_permutation(prng.prng_key(rows), rows, cols)
    assert perm.shape == (rows, cols) and perm.dtype == torch.int64
    assert torch.equal(torch.sort(perm.reshape(-1)).values,
                       torch.arange(rows * cols))
    again = riffle_permutation(prng.prng_key(rows), rows, cols)
    assert torch.equal(perm, again)
    want = np.asarray(jax_riffle(jax.random.PRNGKey(rows), rows, cols))
    np.testing.assert_array_equal(perm.numpy(), want)


def test_epoch_metrics_match_jax_on_ties():
    rng = np.random.default_rng(10)
    scores = np.round(rng.random(200), 1).astype(np.float32)   # many ties
    scores[:5] = [0.0, 1.0, 0.5, 0.5, 1.0 - 1e-7]             # bin edges
    labels = (rng.random(200) < 0.4).astype(np.float32)
    w = (rng.random(200) < 0.8).astype(np.float32)
    ts, tl, tw = map(torch.as_tensor, (scores, labels, w))
    js, jl, jw = map(jnp.asarray, (scores, labels, w))
    for bins in (7, 512):
        pos = score_histogram(ts, tw * tl, bins)
        neg = score_histogram(ts, tw * (1 - tl), bins)
        jpos = jax_histogram(js, jw * jl, bins)
        jneg = jax_histogram(js, jw * (1 - jl), bins)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
        np.testing.assert_allclose(device_auc_hist(pos, neg).item(),
                                   float(jax_auc_hist(jpos, jneg)),
                                   rtol=1e-6)
    for weights in (None, w):
        got = device_auc(tl, ts, None if weights is None else tw)
        want = jax.jit(jax_device_auc)(jl, js,
                                       None if weights is None else jw)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.fixture(scope="module", params=AGGRS)
def jax_fit(sampled, request):
    """JAX trainer_from_keys(...).fit over EPOCHS epochs of E queries from
    the key PRNGKey(5), with the aggregator and the parameters before and
    after."""
    nw, ns, spgk, tspgk = sampled
    aggrs = request.param
    rng = np.random.default_rng(33)
    edges = rng.integers(0, N, size=(2, E)).astype(np.int32)
    labels = (rng.random(E) < 0.5).astype(np.float32)
    jtr = jax_trainer(JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs=aggrs,
                             dropout=0.0),
                      spgk, JaxTrainConfig(batch_size=BS, lr=LR))
    params0, opt_state = jtr.init(jax.random.PRNGKey(0), edges[:, :BS])
    key = jax.random.PRNGKey(5)
    params, _, losses, aucs = jtr.fit(params0, opt_state,
                                      jnp.asarray(edges),
                                      jnp.asarray(labels), key, EPOCHS)
    flat = lambda p: params_from_flax(jax.tree.map(np.asarray, p))
    return (aggrs, edges, labels, flat(params0), flat(params),
            np.asarray(losses), np.asarray(aucs), prng.as_key(key))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_matches_jax(sampled, jax_fit, route):
    nw, ns, spgk, tspgk = sampled
    aggrs, edges, labels, state0, want, losses, aucs, key = jax_fit
    net = Net(ns + 1, H, aggrs=aggrs, dropout=0.0,
              fused_hidden=ROUTES[route], key=prng.prng_key(0), device="cpu")
    net.load_state_dict(state0)
    tr = trainer_from_keys(net, tspgk, TrainConfig(batch_size=BS, lr=LR))
    # JAX's key: the port draws JAX's batch order itself
    got_losses, got_aucs = tr.fit(edges, labels, EPOCHS, key)
    assert net.training
    assert got_losses.shape == (EPOCHS,) and got_aucs.shape == (EPOCHS,)
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=1e-5)
    np.testing.assert_allclose(got_aucs.numpy(), aucs, atol=1e-6)
    got = net.state_dict()
    moved = max(float(np.abs(want[k].numpy() - state0[k].numpy()).max())
                for k in want)
    assert moved > 3 * LR                    # the fit did train
    steps = EPOCHS * -(-E // BS)
    for k, v in want.items():
        atol = 2 * LR * steps if k == GATE_BIAS else 1e-5
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)
    tr.predict(edges)
    assert not net.training


def test_fit_draws_its_own_permutation_and_dropout(sampled):
    """Without injected permutations the fit shuffles from its key, and
    dropout draws from it too: the same key gives the same fit."""
    nw, ns, spgk, tspgk = sampled
    rng = np.random.default_rng(34)
    edges = torch.as_tensor(rng.integers(0, N, size=(2, E)))
    labels = torch.as_tensor((rng.random(E) < 0.5).astype(np.float32))
    runs = []
    for _ in range(2):
        net = Net(ns + 1, H, dropout=0.5, device="cpu",
                  key=prng.prng_key(1))
        tr = trainer_from_keys(net, tspgk, TrainConfig(batch_size=BS))
        losses, aucs = tr.fit(edges, labels, 2, prng.prng_key(2))
        assert torch.isfinite(losses).all()
        assert ((aucs >= 0) & (aucs <= 1)).all()
        runs.append((losses, net.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_init_redraws_weights_and_resets_adam(sampled):
    nw, ns, spgk, tspgk = sampled
    edges = torch.as_tensor(np.random.default_rng(35).integers(
        0, N, size=(2, E)))
    seeded = lambda: prng.prng_key(7)
    net = Net(ns + 1, H, device="cpu", key=seeded())
    tr = trainer_from_keys(net, tspgk, TrainConfig(batch_size=BS))
    tr.fit(edges, torch.ones(E), 1, prng.prng_key(0))
    assert tr.optimizer.state
    tr.init(seeded())
    assert not tr.optimizer.state
    fresh = Net(ns + 1, H, device="cpu", key=seeded()).state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, fresh[k]), k
