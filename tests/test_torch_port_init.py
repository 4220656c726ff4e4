"""PyTorch port, the weights' initialisation from JAX's key tree.

- `ops/special.py`'s erf, erf_inv and log1p against `jax.lax` on float32
  grids that hold 0, +-(1 - 2^-24), +-1 and the truncation's bounds
  a = erf(-sqrt(2)), b = erf(sqrt(2)): within ULP ulp (bit for bit on a
  host whose XLA contracts to fused multiply-adds, as the x86 CPUs with
  FMA do; the share is printed);
- the bounded `prng.uniform` bit for bit and `prng.truncated_normal`
  within ULP of `jax.random` at two shapes;
- flax's initialisers (`models/init.py`: xavier_normal, the LSTM's
  torch_init uniform, a Dense) against flax's;
- `reset_parameters(prng_key(s))` against flax's `model.init(PRNGKey(s))`
  of the JAX package's modules at two seeds and small widths: Net (mean,
  attn, lstm, fused and unfused; with the feature embedding; the scalar
  branch), LSTMAggregation with and without torch_init, and HONet:
  within ULP parameter by parameter, the same tree, the bit-equal share
  printed; no xavier weight beyond 2 / 0.87962566 = 2.2737 of its
  sigma = sqrt(2 / (fan_in + fan_out));
- the port's and JAX's link-prediction CLIs from one `--seed` on the
  host engine in float32 for one epoch, without `params_from_flax`: the
  initial parameters within ULP, the first epoch's loss within LOSS_RTOL;
- no `torch.Generator` in the port's package.
"""

import argparse
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.cli import main as jcli
from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import HONet as JaxHONet
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.models.layers import LSTMAggregation as JaxLSTM
from surel_plus_tpu.ops import join as jjoin
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.train import loop as jloop
from surel_plus_tpu.utils import config as jconfig
from surel_plus_tpu_torch.cli import main as cli
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import HONet, Net
from surel_plus_tpu_torch.models import init as tinit
from surel_plus_tpu_torch.models.layers import LSTMAggregation
from surel_plus_tpu_torch.ops import prng, special
from surel_plus_tpu_torch.train import loop as tloop
from surel_plus_tpu_torch.utils import config as tconfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ULP = 4                  # the bound on every float32 value held to JAX's
LOSS_RTOL = 1e-5         # the CLI's first loss against JAX's (1.5e-7 seen)
TRUNC = 2.2737           # the largest |w| / sigma of a xavier weight
H = 8
SEEDS = (0, 3)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def ulps(a, b) -> np.ndarray:
    """|a - b| in float32 units in the last place (monotone integer
    order of the bit patterns)."""
    def order(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(order(a) - order(b))


def held(got, want, what) -> float:
    """Asserts got within ULP of want; returns the bit-equal share."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    d = ulps(got, want)
    assert d.max(initial=0) <= ULP, f"{what}: {d.max()} ulp"
    share = float((d == 0).mean()) if d.size else 1.0
    print(f"{what}: max {d.max(initial=0)} ulp, bit-equal {share:.6f}")
    return share


# ------------------------------------------------------------ the functions
def _grid(lo, hi, n, extra):
    g = np.linspace(lo, hi, n, dtype=np.float64).astype(np.float32)
    return np.concatenate([g, np.asarray(extra, np.float32)])


A = float(jax.lax.erf(jnp.float32(-2.0) / np.float32(np.sqrt(2))))


def test_erf_and_erf_inv_match_xla():
    tiny = 1 - 2.0 ** -24
    x = _grid(-4.5, 4.5, 200_001, [0.0, -0.0, tiny, -tiny, 1, -1, A, -A])
    held(special.erf(torch.from_numpy(x)).numpy(),
         jax.jit(jax.lax.erf)(x), "erf")
    u = _grid(-1, 1, 400_001, [0.0, tiny, -tiny, A, -A,
                               np.nextafter(np.float32(1), 0)])
    got = special.erf_inv(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    held(got, want, "erf_inv")
    ends = np.asarray([1, -1], np.float32)
    np.testing.assert_array_equal(
        special.erf_inv(torch.from_numpy(ends)).numpy(),
        jax.lax.erf_inv(ends))                       # +-inf
    w = -(u * u)
    held(special.log1p(torch.from_numpy(w)).numpy(),
         jax.jit(jnp.log1p)(w), "log1p")
    assert float(special.erf(torch.tensor(-2.0) / np.float32(
        np.sqrt(2)))) == A


def test_fma_rounds_once():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=10_000).astype(np.float32) for _ in range(3))
    exact = (a.astype(np.float64) * b + c.astype(np.float64))
    got = special.fma(*map(torch.from_numpy, (a, b, c))).numpy()
    # one rounding of the exact value: at most half an ulp off it
    err = np.abs(got.astype(np.float64) - exact)
    half = np.abs(np.spacing(got)).astype(np.float64) / 2
    assert (err <= half).all()


@pytest.mark.parametrize("shape", [(96, 384), (37, 5)])
def test_uniform_and_truncated_normal_match_jax(shape):
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
        for lo, hi in ((A, -A), (-H ** -0.5, H ** -0.5), (0.0, 1.0)):
            np.testing.assert_array_equal(
                prng.uniform(tk, shape, "cpu", lo, hi).numpy(),
                jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        held(prng.truncated_normal(tk, -2, 2, shape, "cpu").numpy(),
             jax.random.truncated_normal(jk, -2.0, 2.0, shape),
             f"truncated_normal {shape}")


@pytest.mark.parametrize("shape", [(4, 16), (96, 384), (16, 1)])
def test_initialisers_match_flax(shape):
    xavier = fnn.initializers.xavier_normal()
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
        held(tinit.xavier_normal(tk, shape, "cpu").numpy(),
             xavier(jk, shape), f"xavier_normal {shape}")
        bound = float(H) ** -0.5
        np.testing.assert_array_equal(
            prng.uniform(tk, shape, "cpu", -bound, bound).numpy(),
            jax.random.uniform(jk, shape, jnp.float32, -bound, bound))
        dense = fnn.Dense(shape[1], kernel_init=xavier)
        p = dense.init(jk, jnp.zeros((1, shape[0])))["params"]
        lin = torch.nn.Linear(*shape)
        tinit.reset(tinit.dense_draws(lin, ()), tk)
        held(lin.weight.detach().numpy().T, p["kernel"], f"Dense {shape}")
        np.testing.assert_array_equal(lin.bias.detach().numpy(), p["bias"])


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module")
def joins():
    """A JAX keys join (lo-only, M=20, S'=3) of 8 queries, a hyperedge
    join of 8 hyperedges over the same sets, and a scalar join."""
    nw, ns = 20, 3
    g = rmat_graph(100, 400, seed=13)
    s = sample_gsets_device_keys(g, np.arange(100, dtype=np.int32),
                                 num_walks=nw, num_steps=ns, seed=2,
                                 block_size=64)
    rows = (s.nodes, s.khi, s.klo, s.sizes)
    rng = np.random.default_rng(14)
    edges = jnp.asarray(rng.integers(0, 100, size=(2, 8)), jnp.int32)
    he = jnp.asarray(rng.integers(0, 100, size=(3, 8)), jnp.int32)
    kj = jax.jit(jjoin.make_keys_join(nw, ns))(*rows, edges)
    hj = jjoin.make_keys_hjoin(nw, ns)(*rows, he)
    sj = jjoin.JoinedBatch(
        eidx=jnp.asarray(rng.random((2, 8, 6, 2)), jnp.float32),
        mask=jnp.ones((2, 8, 6), bool), sizes=jnp.full((2, 8), 6,
                                                       jnp.int32))
    return nw, ns, kj, hj, sj


def _flax(module, *args):
    return {s: jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(s), jnp.zeros((1, 1), jnp.float32), *args))
        for s in SEEDS}


def _held_tree(port, params, what):
    state = params_from_flax(params)
    got = port.state_dict()
    assert sorted(got) == sorted(state), what
    shares = [held(got[k].numpy(), v.numpy(), f"{what} {k}")
              for k, v in state.items()]
    print(f"{what}: bit-equal share over parameters "
          f"{np.mean(shares):.6f}")
    _truncated(port, what)


def _truncated(module, what):
    """Every xavier weight within TRUNC of its sigma (and not all tiny)."""
    for name, p in module.named_parameters():
        w = p.detach()
        if w.dim() != 2:
            continue
        sigma = (2.0 / (w.shape[0] + w.shape[1])) ** 0.5
        top = float(w.abs().max()) / sigma
        assert 0.5 < top <= TRUNC, (what, name, top)


@pytest.mark.parametrize("aggrs", ["mean", "attn", "lstm"])
def test_net_init_matches_flax(joins, aggrs):
    nw, ns, kj, _, _ = joins
    for fused in (False, True):
        want = _flax(JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs=aggrs,
                            key_layout=(nw, ns), fused_hidden=fused), kj)
        for s in SEEDS:
            for tfused in (False, True):
                net = Net(ns + 1, H, aggrs=aggrs, key_layout=(nw, ns),
                          fused_hidden=tfused, key=prng.prng_key(s),
                          device="cpu")
                _held_tree(net, want[s], f"{aggrs} jax fused={fused} "
                           f"port fused={tfused} seed {s}")


def test_net_feature_and_scalar_branches_match_flax(joins):
    nw, ns, kj, _, sj = joins
    feat = jnp.asarray(np.random.default_rng(3).normal(size=(2, 8, 5)),
                       jnp.float32)
    want = _flax(JaxNet(input_dim=ns + 1, hidden_dim=H, use_feature=True,
                        x_dim=5, key_layout=(nw, ns)), kj, feat)
    for s in SEEDS:
        net = Net(ns + 1, H, use_feature=True, x_dim=5, key=prng.prng_key(s),
                  device="cpu")
        _held_tree(net, want[s], f"feature seed {s}")
    for aggrs in ("mean", "lstm"):
        want = _flax(JaxNet(input_dim=1, hidden_dim=H, aggrs=aggrs), sj)
        for s in SEEDS:
            net = Net(1, H, aggrs=aggrs, key=prng.prng_key(s), device="cpu")
            _held_tree(net, want[s], f"scalar {aggrs} seed {s}")


@pytest.mark.parametrize("torch_init", [False, True])
def test_lstm_aggregation_init_matches_flax(torch_init):
    x = jnp.zeros((2, 3, H), jnp.float32)
    mask = jnp.ones((2, 3), bool)
    for s in SEEDS:
        p = JaxLSTM(H, torch_init=torch_init).init(
            jax.random.PRNGKey(s), x, mask)["params"]
        m = LSTMAggregation(H, torch_init=torch_init)
        m.reset_parameters(prng.prng_key(s))
        for k in ("wi", "wh", "bh"):
            got = getattr(m, k).detach().numpy()
            if torch_init:
                np.testing.assert_array_equal(got, p[k])
            else:
                held(got, p[k], f"lstm {k} seed {s}")
        if not torch_init:
            _truncated(m, "lstm")


def test_honet_init_matches_flax(joins):
    nw, ns, _, hj, _ = joins
    want = _flax(JaxHONet(input_dim=ns + 1, hidden_dim=H,
                          fused_hidden=False), hj)
    for s in SEEDS:
        net = HONet(ns + 1, H, key_layout=(nw, ns), key=prng.prng_key(s),
                    device="cpu")
        _held_tree(net, want[s], f"honet seed {s}")


def test_reset_parameters_redraws_from_the_key():
    a = Net(4, H, aggrs="lstm", key=prng.prng_key(5), device="cpu")
    b = Net(4, H, aggrs="lstm", key=prng.prng_key(6), device="cpu")
    b.reset_parameters(prng.prng_key(5))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    other = Net(4, H, key=prng.prng_key(0), device="cpu")
    assert not torch.equal(a.pe_embedding.fc0.weight,
                           other.pe_embedding.fc0.weight)


@pytest.mark.parametrize("make", [
    lambda **kw: Net(4, H, aggrs="lstm", use_feature=True, x_dim=5, **kw),
    lambda **kw: Net(4, H, aggrs="attn", **kw),
    lambda **kw: HONet(4, H, **kw)], ids=["net_lstm_feature", "net_attn",
                                         "honet"])
def test_key_is_required_and_none_draws_nothing(make):
    """As flax's `init` takes a key, the models take one: none given
    raises, None leaves every parameter NaN until `reset_parameters`,
    which then gives the key's weights."""
    with pytest.raises(TypeError):
        make(device="cpu")
    m = make(key=None, device="cpu")
    assert all(bool(p.isnan().all()) for p in m.parameters())
    m.reset_parameters(prng.prng_key(3))
    want = make(key=prng.prng_key(3), device="cpu").state_dict()
    for k, v in m.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("aggrs", ["mean", "attn", "lstm"])
def test_draws_list_every_parameter_once(aggrs):
    """`draws()` names each parameter once, with flax's scope path and
    count, and redrawing one entry gives the model's value."""
    net = Net(4, H, aggrs=aggrs, use_feature=True, x_dim=5,
              key=prng.prng_key(2), device="cpu")
    draws = net.draws()
    assert sorted(id(d.param) for d in draws) == sorted(
        id(p) for p in net.parameters())
    for d in draws:
        v = d.value(prng.prng_key(2))
        got = d.param.detach()
        if v is None:
            assert not got.any()
        else:
            assert torch.equal(v.t() if d.transposed else v, got)


# ------------------------------------------------------------ the CLI
CLI_TOY = ["--dataset", "synth-collab", "--synth_nodes", "600",
           "--synth_edges", "3000", "--num_walks", "8", "--num_steps", "3",
           "--epochs", "1", "--eval_steps", "1", "--runs", "1",
           "--batch_size", "256", "--hidden_channels", "16", "--seed", "5",
           "--engine", "host"]


def _config(pkg, argv):
    parser = argparse.ArgumentParser()
    pkg.add_config_args(parser)
    return pkg.apply_dataset_overrides(
        pkg.config_from_args(parser.parse_args(argv)))


def test_cli_starts_from_jax_weights(tmp_path, monkeypatch):
    """Both link-prediction CLIs from `--seed 5` on the host engine in
    float32, one epoch, dropout 0.1: the port's run 0 starts from the
    weights JAX's starts from (no params_from_flax), and its first
    epoch's loss, over the same sets, batch order and dropout masks,
    equals JAX's within LOSS_RTOL."""
    seen = {"jax": {}, "port": {}}
    jinit, jepoch = jloop.LinkPredictor.init, jloop.LinkPredictor.train_epoch
    tinit_, tepoch = tloop.LinkPredictor.init, tloop.LinkPredictor.train_epoch

    def jax_init(self, rng, example_edges):
        out = jinit(self, rng, example_edges)
        seen["jax"].setdefault("params", jax.tree.map(np.asarray, out[0]))
        return out

    def jax_epoch(self, *a, **k):
        out = jepoch(self, *a, **k)
        seen["jax"].setdefault("loss", float(out[2]))
        return out

    def port_init(self, key):
        tinit_(self, key)
        seen["port"].setdefault("params", {
            k: v.detach().clone() for k, v in self.model.state_dict().items()})

    def port_epoch(self, *a, **k):
        out = tepoch(self, *a, **k)
        seen["port"].setdefault("loss", float(out[0]))
        return out

    monkeypatch.setattr(jloop.LinkPredictor, "init", jax_init)
    monkeypatch.setattr(jloop.LinkPredictor, "train_epoch", jax_epoch)
    monkeypatch.setattr(tloop.LinkPredictor, "init", port_init)
    monkeypatch.setattr(tloop.LinkPredictor, "train_epoch", port_epoch)
    jcli.run_experiment(_config(jconfig, [*CLI_TOY, "--log_dir",
                                          str(tmp_path / "j")]))
    out = cli.run_experiment(_config(tconfig, [*CLI_TOY, "--log_dir",
                                               str(tmp_path / "t")]),
                             device="cpu")
    assert isinstance(out["trainer"], tloop.LinkPredictor)
    assert out["trainer"].model.dtype == torch.float32
    want = params_from_flax(seen["jax"]["params"])
    got = seen["port"]["params"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        held(got[k].numpy(), v.numpy(), f"cli initial {k}")
    j, t = seen["jax"]["loss"], seen["port"]["loss"]
    print(f"first epoch's loss: jax {j!r}, port {t!r}, "
          f"relative {abs(t - j) / abs(j):.3e}")
    assert abs(t - j) <= LOSS_RTOL * abs(j)


def test_no_torch_generator_in_the_port():
    found = [f"{p.relative_to(ROOT)}:{i}"
             for p in sorted((ROOT / "surel_plus_tpu_torch").rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if "torch.Generator" in line]
    assert not found, found
