"""PyTorch port, the encoding-table path: the device dedup, the table
samplers, `gather_join`, the masked LSTM over given rows (the plain
version of K5), the Net's table and direct embed routes and the table
trainer, each against the JAX package on the same inputs.

Tolerances, with their reasons:
- dedup, samplers and join: exact (integer tables and indices, and the
  encodings' counts). The normalized encodings (counts / num_walks) are
  the port's keys features bit for bit; JAX's jitted table differs from
  them by up to 1 ulp, since under jit XLA turns the division into a
  multiply by the reciprocal (as tests/test_torch_port_join.py notes), so
  against JAX they are held to 1 ulp;
- the masked LSTM: rtol = atol = 1e-5 in fp32 (as JAX's own test holds
  its kernel to its scan, tests/test_pallas_hidden_sum.py:263-285: the
  same recurrence with sums in other orders);
- Net logits: rtol = atol = 1e-4 in fp32; 3e-2 in bf16, where the
  frameworks round to bf16 at different points; the table and direct
  embed modes against each other: rtol = atol = 1e-6 (the same hidden
  rows, from matrix products of other shapes);
- the trainer: predict scores rtol = atol = 1e-5; one step's loss rtol
  1e-5 and gradients rtol 1e-4, atol 1e-6, the attention gate's bias
  atol 1e-5, and the fit's parameters rtol 1e-4, atol 1e-5, the gate's
  bias 2 lr a step, as tests/test_torch_port_train.py holds the keys
  trainer (its docstring says why); the lstm fit's atol 1e-4, the spread
  of JAX's own two lstm routes on that fit (the test says why); the
  fused and unfused table lstm routes' gradients against each other:
  rtol 1e-4, atol 1e-6.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import gather_join as jax_gather_join
from surel_plus_tpu.ops.pallas.lstm_kernel import (
    lstm_final_hidden as jax_lstm_final_hidden,
)
from surel_plus_tpu.ops.sampler import (
    sample_gsets_device as jax_sample_gsets_device,
)
from surel_plus_tpu.ops.sampler import (
    sample_gsets_device_keys as jax_sample_gsets_device_keys,
)
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import DeviceTrainer as JaxDeviceTrainer
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import gather_join, unpack_key_features
from surel_plus_tpu_torch.ops.kernels.lstm import (
    lstm_final_hidden,
    lstm_final_hidden_bwd_plain,
    lstm_final_hidden_cuda,
    lstm_final_hidden_plain,
)
from surel_plus_tpu_torch.ops.sampler import (
    dedup_device,
    sample_gsets,
    sample_gsets_device,
    sample_gsets_device_keys,
    table_width,
)
from surel_plus_tpu_torch.spg import SpGDevice
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import DeviceTrainer, batch_loss
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (num_walks, num_steps, enc_width, max_enc_width) of each dedup case
DEDUP = {"lo_only": (16, 3, 4096, 1 << 16),
         "lead_in_hi": (200, 4, 4096, 1 << 16),
         "general": (1000, 4, 4096, 1 << 16),
         "widening": (16, 3, 8, 16)}
N, H = 48, 16
AGGRS = ("attn", "lstm", "mean")
GATE_BIAS = "aggr.gate_nn.bias"   # gradient 0 up to rounding
BS, E, EPOCHS, LR = 8, 21, 2, 1e-2   # E % BS != 0


def _c(x):
    """A JAX array -> a torch tensor with the same bits (uint32 as int32)."""
    x = np.array(x)
    return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)


def _tdev(jdev):
    return SpGDevice(nodes=_c(jdev.nodes), eidx=_c(jdev.eidx),
                     sizes=_c(jdev.sizes), enc=_c(jdev.enc))


# ------------------------------------------------------------ the dedup
@pytest.mark.parametrize("case", sorted(DEDUP))
def test_dedup_matches_jax(case):
    """The JAX-walked keys through the port's dedup against JAX's
    `sample_gsets_device` (its merge tree and widening loop) on the same
    walks: the same indices, table, unique count and table rows."""
    nw, ns, width, max_width = DEDUP[case]
    g = jax_rmat_graph(N, 240, seed=21)
    seeds = np.arange(N, dtype=np.int32)
    kw = dict(num_walks=nw, num_steps=ns, seed=4, block_size=32)
    keys = jax_sample_gsets_device_keys(g, seeds, **kw)
    jdev, ju = jax_sample_gsets_device(g, seeds, enc_width=width,
                                       max_enc_width=max_width, **kw)
    eidx, enc, u = dedup_device(_c(keys.sizes), _c(keys.khi),
                                _c(keys.klo), nw, ns, width, max_width)
    assert u == ju
    if case == "widening":
        assert u > max_width                 # the loop widened past the max
    jenc = np.asarray(jdev.enc)
    assert enc.shape == jenc.shape
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jdev.eidx))
    np.testing.assert_array_equal(np.rint(enc.numpy() * nw),
                                  np.rint(jenc * nw))
    np.testing.assert_array_max_ulp(enc.numpy(), jenc, maxulp=1)
    np.testing.assert_array_equal(_c(keys.nodes).numpy(),
                                  np.asarray(jdev.nodes))


@pytest.mark.parametrize("u,n,bucket,enc_width,want", [
    (5, 10, 49, 4096, 490),      # capped at the visit total
    (60, 300, 49, 64, 64),       # fits the first width
    (65, 300, 49, 64, 256),      # one widening
    (300, 300, 49, 8, 784),      # from max(enc_width, bucket) = 49, x4 x4
    (14000, 300, 49, 64, 14700)])  # capped while widening
def test_table_width_follows_jax_widening(u, n, bucket, enc_width, want):
    assert table_width(u, n, bucket, enc_width) == want


@pytest.fixture(scope="module", params=[(16, 3), (200, 4)],
                ids=["lo_only", "lead_in_hi"])
def port_sets(request):
    nw, ns = request.param
    g = rmat_graph(N, 240, seed=22)
    kw = dict(num_walks=nw, num_steps=ns, seed=5, block_size=32,
              device="cpu")
    seeds = np.arange(N)
    dev, u = sample_gsets_device(g, seeds, **kw)
    return nw, ns, dev, u, sample_gsets_device_keys(g, seeds, **kw), \
        sample_gsets(g, seeds, **kw)


def test_table_sampler_matches_keys_sampler(port_sets):
    """The same walks as the keys sampler's; each valid slot's table row is
    its key unpacked; padded slots index the zero row."""
    nw, ns, dev, u, keys, _ = port_sets
    assert torch.equal(dev.nodes, keys.nodes)
    assert torch.equal(dev.sizes, keys.sizes)
    valid = (torch.arange(dev.nodes.shape[1])[None, :]
             < dev.sizes[:, None].to(torch.int64))
    assert bool((dev.eidx[valid] >= 1).all())
    assert bool((dev.eidx[~valid] == 0).all())
    want = unpack_key_features(keys.khi, keys.klo, nw, ns)
    assert torch.equal(dev.enc[dev.eidx][valid], want[valid])
    assert bool((dev.enc[0] == 0).all()) and bool((dev.enc[u + 1:] == 0).all())
    assert len(torch.unique(dev.enc[1:u + 1], dim=0)) == u


def test_host_sampler_matches_device_dedup(port_sets):
    nw, ns, dev, u, _, host = port_sets
    assert host.num_unique_enc == u
    np.testing.assert_array_equal(host.nodes, dev.nodes.numpy())
    np.testing.assert_array_equal(host.eidx, dev.eidx.numpy())
    np.testing.assert_array_equal(host.enc_normalized(),
                                  dev.enc[:u + 1].numpy())
    moved = host.device("cpu")
    assert torch.equal(moved.eidx, dev.eidx)
    assert torch.equal(moved.enc, dev.enc[:u + 1])
    lut = host.row_lookup()
    assert (lut[host.seeds] == np.arange(host.num_rows)).all()


def test_entry_points_default_to_cuda():
    for fn in (sample_gsets_device, sample_gsets, Net):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------ the join
@pytest.fixture(scope="module", params=[(16, 3), (1000, 4)],
                ids=["lo_only", "general"])
def jax_sets(request):
    """JAX-sampled encoding-table sets and one batch of query edges."""
    nw, ns = request.param
    g = jax_rmat_graph(N, 240, seed=23)
    jdev, u = jax_sample_gsets_device(g, np.arange(N, dtype=np.int32),
                                      num_walks=nw, num_steps=ns, seed=6,
                                      block_size=32)
    edges = np.random.default_rng(24).integers(0, N, size=(2, 12)).astype(
        np.int32)
    return nw, ns, jdev, edges


def test_gather_join_matches_jax(jax_sets):
    """Exactly JAX's join, on any key layout (the general one included:
    the payload is the table index)."""
    _, _, jdev, edges = jax_sets
    want = jax_gather_join(jdev.nodes, jdev.eidx, jdev.sizes,
                           jnp.asarray(edges))
    tdev = _tdev(jdev)
    got = gather_join(tdev.nodes, tdev.eidx, tdev.sizes,
                      torch.as_tensor(edges))
    assert got.eidx.dtype == torch.int32 and got.eidx.shape[-1] == 2
    np.testing.assert_array_equal(got.eidx.numpy(), np.asarray(want.eidx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert bool((got.eidx[..., 1] > 0).any())     # partners were found


# ------------------------------------------------------------ K5's plain
def _lstm_operands(holes, seed=7):
    """x [9, 23, 6], masks, wi [6, 32], wh [8, 32], bh [32] (the shapes of
    tests/test_pallas_hidden_sum.py:263-285): prefix masks of random sizes
    >= 1, or, with `holes`, random masks with row 0 empty and row 1 valid
    only at its last slot."""
    rng = np.random.default_rng(seed)
    b, ell, h, hh = 9, 23, 6, 8
    x = rng.normal(size=(b, ell, h)).astype(np.float32)
    if holes:
        mask = rng.random((b, ell)) < 0.6
        mask[0] = False
        mask[1] = False
        mask[1, -1] = True
    else:
        sizes = rng.integers(1, ell + 1, size=b)
        mask = np.arange(ell)[None, :] < sizes[:, None]
    w = lambda *s: (0.4 * rng.normal(size=s)).astype(np.float32)
    return x, mask, w(h, 4 * hh), w(hh, 4 * hh), w(4 * hh)


@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
def test_lstm_final_hidden_plain_matches_jax(holes):
    ops = _lstm_operands(holes)
    want = np.asarray(jax_lstm_final_hidden(*map(jnp.asarray, ops),
                                            interpret=True))
    got = lstm_final_hidden_plain(*map(torch.as_tensor, ops))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        routed = lstm_final_hidden(*map(torch.as_tensor, ops))
    assert torch.equal(routed, got)
    if holes:
        assert bool((got[0] == 0).all())


def test_lstm_final_hidden_casts_before_the_input_product():
    """A bf16 x and wi are cast to float32 first: the result equals the
    float32 run on the bf16 values."""
    x, mask, wi, wh, bh = map(torch.as_tensor, _lstm_operands(False))
    xb, wib = x.to(torch.bfloat16), wi.to(torch.bfloat16)
    got = lstm_final_hidden_plain(xb, mask, wib, wh, bh)
    want = lstm_final_hidden_plain(xb.float(), mask, wib.float(), wh, bh)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_lstm_final_hidden_is_forward_only():
    """`lstm_final_hidden` is differentiable (the name dates from when it
    was not): in x, wi, wh and bh (the plain BPTT's gradients, bit for
    bit, on the CPU), not in the mask, and it gives the same output with
    grad mode off."""
    ops = [torch.as_tensor(a) for a in _lstm_operands(True)]
    x, mask, wi, wh, bh = ops
    for t in (x, wi, wh, bh):
        t.requires_grad_()
    out = lstm_final_hidden(x, mask, wi, wh, bh)
    assert out.shape == (9, 8) and out.requires_grad
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=(9, 8)).astype(np.float32))
    (out * g).sum().backward()
    want = lstm_final_hidden_bwd_plain(*(t.detach() for t in ops), g)
    for name, t, w in zip(("x", "wi", "wh", "bh"), (x, wi, wh, bh), want):
        assert torch.equal(t.grad, w), name
        assert bool((t.grad != 0).any()), name
    with torch.no_grad():
        assert torch.equal(lstm_final_hidden(x, mask, wi, wh, bh), out)


def test_cuda_wrapper_rejects_cpu_tensors():
    x, mask, wi, wh, bh = map(torch.as_tensor, _lstm_operands(False))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        lstm_final_hidden_cuda(x, mask, wi, wh, bh)


def test_other_devices_raise():
    """No fallback: a device with no kernel and no plain route raises."""
    z = lambda *s, **kw: torch.zeros(*s, device="meta", **kw)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lstm_final_hidden(z(9, 23, 6), z(9, 23, dtype=torch.bool),
                          z(6, 32), z(8, 32), z(32))


# ------------------------------------------------------------ the Net
@pytest.fixture(scope="module")
def net_case():
    """JAX-sampled lo-only sets, one batch joined by JAX, and each
    aggregator's flax weights (the LSTM's bias nonzero)."""
    g = jax_rmat_graph(N, 240, seed=25)
    jdev, _ = jax_sample_gsets_device(g, np.arange(N, dtype=np.int32),
                                      num_walks=16, num_steps=3, seed=8,
                                      block_size=32)
    edges = np.random.default_rng(26).integers(0, N, size=(2, 12)).astype(
        np.int32)
    jj = jax_gather_join(jdev.nodes, jdev.eidx, jdev.sizes,
                         jnp.asarray(edges))
    params = {}
    for aggrs in AGGRS:
        jnet = JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs, dropout=0.0)
        p = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(1),
                                               jdev.enc, jj))
        if aggrs == "lstm":
            p["params"]["aggr"]["bh"] = np.random.default_rng(9).normal(
                scale=0.2, size=p["params"]["aggr"]["bh"].shape).astype(
                np.float32)
        params[aggrs] = p
    return jdev, edges, jj, params


def _port_net(params, aggrs, **kw):
    net = Net(4, H, aggrs=aggrs, dropout=0.0,
              key=prng.prng_key(0), device="cpu", **kw)
    net.load_state_dict(params_from_flax(params))
    return net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", ["table", "direct"])
@pytest.mark.parametrize("aggrs", AGGRS)
def test_table_net_matches_jax(net_case, aggrs, mode, fused, dtype):
    """The port's Net on a table join against JAX's, route for route: the
    fused routes are the table path's (masked_mean, the folded attention
    pool, the masked LSTM over x, in Pallas interpret mode in JAX)."""
    jdev, edges, jj, params = net_case
    jnet = JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs, dropout=0.0,
                  embed_mode=mode, dtype=dtype, fused_hidden=fused)
    want = np.asarray(jax.jit(jnet.apply)(params[aggrs], jdev.enc, jj))
    net = _port_net(params[aggrs], aggrs, embed_mode=mode, dtype=dtype,
                    fused_hidden=fused)
    tdev = _tdev(jdev)
    joined = gather_join(tdev.nodes, tdev.eidx, tdev.sizes,
                         torch.as_tensor(edges))
    with torch.no_grad():
        got = net.eval()(joined, enc_table=tdev.enc).numpy()
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("aggrs", AGGRS)
def test_table_and_direct_give_the_same_logits(net_case, aggrs):
    jdev, edges, _, params = net_case
    tdev = _tdev(jdev)
    joined = gather_join(tdev.nodes, tdev.eidx, tdev.sizes,
                         torch.as_tensor(edges))
    net = _port_net(params[aggrs], aggrs, fused_hidden=True).eval()
    with torch.no_grad():
        table = net(joined, enc_table=tdev.enc)
        direct = net(joined, enc_table=tdev.enc, embed_mode="direct")
    assert net.embed_mode == "table"
    np.testing.assert_allclose(direct.numpy(), table.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="enc_table"):
        net(joined)


def test_table_lstm_raises_in_training_and_unfused_trains(net_case):
    """Both table lstm routes train (the name dates from when the fused
    one raised under grad): one step's gradients on the fused route (K5's
    plain pair) equal the unfused route's (torch's autograd of the scan
    over projected rows) in fp32 at rtol 1e-4, atol 1e-6, and a fit on
    each moves every parameter."""
    jdev, edges, _, params = net_case
    tdev = _tdev(jdev)
    joined = gather_join(tdev.nodes, tdev.eidx, tdev.sizes,
                         torch.as_tensor(edges))
    ones = torch.ones(edges.shape[1])
    grads = {}
    for fused in (True, False):
        net = _port_net(params["lstm"], "lstm", fused_hidden=fused)
        batch_loss(net.train()(joined, enc_table=tdev.enc,
                               embed_mode="direct"), ones, ones).backward()
        grads[fused] = {n: p.grad for n, p in net.named_parameters()}
        start = {k: v.clone() for k, v in net.state_dict().items()}
        losses, _ = DeviceTrainer(net, tdev, TrainConfig(batch_size=4)).fit(
            edges, ones, 1, prng.prng_key(0))
        assert bool(torch.isfinite(losses).all())
        assert all(not torch.equal(v, start[k])
                   for k, v in net.state_dict().items())
    for name, want in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------ the trainer
@pytest.mark.parametrize("aggrs", AGGRS)
def test_table_predict_matches_jax(net_case, aggrs):
    jdev, _, _, params = net_case
    edges = np.random.default_rng(27).integers(0, N, size=(2, E)).astype(
        np.int32)
    jtr = JaxDeviceTrainer(JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs),
                           jdev, JaxTrainConfig(batch_size=BS))
    want = np.asarray(jtr.predict(params[aggrs], edges))
    net = _port_net(params[aggrs], aggrs)
    got = DeviceTrainer(net, _tdev(jdev), TrainConfig(batch_size=BS)
                        ).predict(edges)
    assert got.shape == (E,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("aggrs", AGGRS)
def test_table_train_step_matches_jax(net_case, aggrs, fused):
    """One training step's loss and gradients in the trainer's embed mode
    ("direct") against jax.value_and_grad of JAX's. JAX's fused lstm
    route trains through its folded scan (net.py:219-224), the port's
    through K5's pair (its plain versions here): in fp32 the same
    function."""
    jdev, edges, jj, params = net_case
    rng = np.random.default_rng(28)
    labels = (rng.random(edges.shape[1]) < 0.5).astype(np.float32)
    w = np.ones(edges.shape[1], np.float32)
    w[-3:] = 0.0                                   # padded ids weigh 0
    jnet = JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs, dropout=0.0,
                  embed_mode="direct", fused_hidden=fused)

    def loss_fn(p):
        logits = jnet.apply(p, jdev.enc, jj, train=True)
        per = optax.sigmoid_binary_cross_entropy(logits, labels)
        return (per * w).sum() / jnp.maximum(w.sum(), 1.0)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params[aggrs])
    want = params_from_flax(jax.tree.map(np.asarray, want_grads))
    net = _port_net(params[aggrs], aggrs, fused_hidden=fused)
    tr = DeviceTrainer(net, _tdev(jdev), TrainConfig(batch_size=BS))
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
def test_table_fit_matches_jax(net_case, aggrs):
    """JAX's DeviceTrainer.fit over EPOCHS epochs against the port's with
    JAX's permutations injected: on the CPU route for mean and attn, on
    the fused route for lstm (JAX's folded scan; the port's K5 pair, its
    plain versions here). The lstm fit's parameters are held to atol
    1e-4: Adam turns rounding in its small gradients into steps that
    differ by up to about 1e-4 after these 6 steps, as JAX's own fused
    and unfused routes differ by 7.6e-5 on this fit."""
    jdev, _, _, _ = net_case
    fused = True if aggrs == "lstm" else None
    rng = np.random.default_rng(29)
    edges = rng.integers(0, N, size=(2, E)).astype(np.int32)
    labels = (rng.random(E) < 0.5).astype(np.float32)
    jtr = JaxDeviceTrainer(JaxNet(input_dim=4, hidden_dim=H, aggrs=aggrs,
                                  dropout=0.0, fused_hidden=fused),
                           jdev, JaxTrainConfig(batch_size=BS, lr=LR))
    params0, opt_state = jtr.init(jax.random.PRNGKey(0), edges[:, :BS])
    key = jax.random.PRNGKey(5)
    params, _, losses, aucs = jtr.fit(params0, opt_state,
                                      jnp.asarray(edges),
                                      jnp.asarray(labels), key, EPOCHS)
    flat = lambda p: params_from_flax(jax.tree.map(np.asarray, p))
    state0, want = flat(params0), flat(params)
    net = Net(4, H, aggrs=aggrs, dropout=0.0, fused_hidden=fused,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(state0)
    tr = DeviceTrainer(net, _tdev(jdev), TrainConfig(batch_size=BS, lr=LR))
    got_losses, got_aucs = tr.fit(edges, labels, EPOCHS, prng.as_key(key))
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=1e-5)
    np.testing.assert_allclose(got_aucs.numpy(), np.asarray(aucs),
                               atol=1e-6)
    moved = max(float(np.abs(want[k].numpy() - state0[k].numpy()).max())
                for k in want)
    assert moved > 3 * LR                    # the fit did train
    got = net.state_dict()
    fit_atol = 1e-4 if aggrs == "lstm" else 1e-5
    for k, v in want.items():
        atol = 2 * LR * EPOCHS * -(-E // BS) if k == GATE_BIAS else fit_atol
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)
