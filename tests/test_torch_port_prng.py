"""PyTorch port, the JAX package's key-based draws (`ops/prng.py`, the
threefry kernel's plain version `ops/kernels/threefry.py`) against
`jax.random` and flax, bit for bit:

- the layout: JAX's `jax_threefry_partitionable` must be on, the only
  layout the port implements;
- threefry2x32-20's known answer (Random123: key (0, 0), counter (0, 0)
  -> 0x6b200159, 0x99ba4efe) and JAX's own threefry_2x32 on counters
  that cross 2^32;
- `prng_key` (with a seed's high word under x64), `fold_in`, `split`,
  `bits` (several shapes, a row block of a larger draw through
  `offset`), `uniform` and `bernoulli`;
- flax's `_fold_in_static`, the scope path of the JAX package's one
  Dropout in `Net` (mean, attn and lstm) and `HONet` (read off flax
  while they apply), and the dropout masks of one apply in float32 and
  bfloat16;
- the seed-sharded sampler's rank keys (`fold_in(PRNGKey(seed), rank)`)
  against JAX's `sample_gsets_sharded` on four virtual devices;
- two-epoch device-trainer fits at dropout 0.1 in float32 from JAX's
  carried weights and JAX's key, the mean Net and HONet: losses rtol
  1e-5, AUCs atol 1e-6, parameters rtol 1e-4, atol 1e-5, the tolerances
  of the train-step parity in tests/test_torch_port_train.py (sums in
  other orders).
"""

import flax.core.scope as flax_scope
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import HONet as JaxHONet
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops import join as jjoin
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.parallel import dist as jdist
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.models import HONet, Net
from surel_plus_tpu_torch.models.layers import DROPOUT_PATH, dropout
from surel_plus_tpu_torch.ops import join as join_ops
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops import walk as walk_ops
from surel_plus_tpu_torch.ops.kernels.threefry import (
    threefry2x32,
    threefry_bits,
)
from surel_plus_tpu_torch.ops.sampler import device_graph, walk_tables_for
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import trainer_from_keys
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, BS, LR = 16, 8, 1e-2
KEYS = (jax.random.PRNGKey(0), jax.random.PRNGKey(111413),
        jax.random.fold_in(jax.random.PRNGKey(7), 3))


def _words(key):
    return tuple(np.asarray(key).tolist())


def test_jax_draws_in_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is off: JAX's split and bits now draw "
        "another layout than the one ops/prng.py implements")


def test_threefry_known_answer_and_counters_past_2_32():
    assert threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    hi = np.array([0, 0, 1, 1, 7], np.uint32)
    lo = np.array([0xFFFFFFFE, 0xFFFFFFFF, 0, 1, 123], np.uint32)
    k = jnp.asarray([0x9E3779B9, 5], jnp.uint32)
    out = np.asarray(jax._src.prng.threefry_2x32(k, jnp.concatenate(
        [jnp.asarray(hi), jnp.asarray(lo)]))).reshape(2, -1)
    got = threefry2x32(0x9E3779B9, 5, torch.as_tensor(hi.astype(np.int64)),
                       torch.as_tensor(lo.astype(np.int64)))
    np.testing.assert_array_equal(got[0].numpy(), out[0])
    np.testing.assert_array_equal(got[1].numpy(), out[1])
    # a run of counters across 2^32 through the wrapper's offset
    words = threefry_bits(0x9E3779B9, 5, (1 << 32) - 2,
                          torch.empty(4, dtype=torch.int64))
    want = [a ^ b for a, b in (threefry2x32(0x9E3779B9, 5, c >> 32,
                                            c & 0xFFFFFFFF)
                               for c in range((1 << 32) - 2, (1 << 32) + 2))]
    assert words.tolist() == want


def test_threefry_bits_refuses_what_it_cannot_draw():
    out = torch.empty(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        threefry_bits(1 << 32, 0, 0, out)
    with pytest.raises(ValueError):
        threefry_bits(0, 0, -1, out)
    with pytest.raises(ValueError):
        threefry_bits(0, 0, 0, torch.empty(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        threefry_bits(0, 0, 0, torch.empty(4, 2, dtype=torch.int64).t())


@pytest.mark.parametrize("seed", [0, 1, 42, 111413, 2 ** 31 - 1])
def test_prng_key_matches_jax(seed):
    assert prng.prng_key(seed) == _words(jax.random.PRNGKey(seed))


def test_prng_key_keeps_the_high_word():
    with jax.enable_x64(True):
        for seed in (2 ** 40 + 3, 2 ** 63 - 1, -1, -5):
            assert prng.prng_key(seed) == _words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("key", KEYS, ids=["0", "111413", "folded"])
def test_fold_in_and_split_match_jax(key):
    k = prng.as_key(key)
    for d in (0, 1, 7, 0x5EED, 2 ** 31, 2 ** 32 - 1):
        assert prng.fold_in(k, d) == _words(jax.random.fold_in(key, d))
    for n in (1, 2, 3, 5):
        assert prng.split(k, n) == [_words(x)
                                    for x in jax.random.split(key, n)]


@pytest.mark.parametrize("shape", [(8,), (1,), (3, 7), (2, 5, 4),
                                   (1023,), (65, 33)])
@pytest.mark.parametrize("key", KEYS, ids=["0", "111413", "folded"])
def test_bits_uniform_bernoulli_match_jax(key, shape):
    k = prng.as_key(key)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(prng.bits(k, shape, "cpu").numpy(),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(k, shape, "cpu").numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    for p in (0.9, 0.5, 1e-3):
        np.testing.assert_array_equal(
            prng.bernoulli(k, p, shape, "cpu").numpy(),
            np.asarray(jax.random.bernoulli(key, p, shape)))


def test_bits_offset_is_a_row_block_of_a_larger_draw():
    key = KEYS[1]
    whole = np.asarray(jax.random.bits(key, (12, 10), jnp.uint32))
    for a, r in ((0, 12), (3, 4), (11, 1)):
        got = prng.bits(prng.as_key(key), (r, 10), "cpu", offset=a * 10)
        np.testing.assert_array_equal(got.numpy(), whole[a:a + r])
    # the walk's step draws: rows of every step key's draw
    got = walk_ops.walk_bits(prng.as_key(key), 4, 10, 3, "cpu", row0=5)
    for t, sk in enumerate(jax.random.split(key, 2)):
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(
            jax.random.bits(sk, (12, 10), jnp.uint32))[5:9])


def test_key_words_round_trip():
    key = prng.split(prng.prng_key(3), 4)[3]
    words = prng.key_words(key)
    assert words.dtype == np.uint32 and words.shape == (2,)
    assert prng.as_key(words) == key
    assert prng.as_key(torch.as_tensor(words.view(np.int32))) == key
    with pytest.raises(ValueError):
        prng.as_key(np.zeros(3, np.uint32))


@pytest.mark.parametrize("names", [
    ("affinity_score", "Dropout_0", 1), ("merge", "Dropout_0", 1),
    ("a",), (0,), (300, "x", 2 ** 40)])
def test_fold_in_static_matches_flax(names):
    key = KEYS[2]
    assert prng.fold_in_static(prng.as_key(key), names) == _words(
        flax_scope._fold_in_static(key, names))
    assert prng.fold_in_static(prng.as_key(key), ()) == _words(key)


# ------------------------------------------------------------ dropout
@pytest.fixture(scope="module")
def sets():
    """Lo-only sets (M=8, S'=3) of a 120-node graph, both packages'."""
    g = jax_rmat_graph(120, 600, seed=31)
    spgk = sample_gsets_device_keys(g, np.arange(120, dtype=np.int32),
                                    num_walks=8, num_steps=3, seed=6,
                                    block_size=64)
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    return spgk, SpGKeys(nodes=c(spgk.nodes), khi=c(spgk.khi),
                         klo=c(spgk.klo), sizes=c(spgk.sizes), num_walks=8,
                         num_steps=3)


def _jax_batch(spgk, hyper):
    rows = (spgk.nodes, spgk.khi, spgk.klo, spgk.sizes)
    e = np.random.default_rng(2).integers(0, 120, size=(3 if hyper else 2,
                                                        12)).astype(np.int32)
    join = jjoin.make_keys_hjoin if hyper else jjoin.make_keys_join
    return join(8, 3)(*rows, jnp.asarray(e))


@pytest.mark.parametrize("model", ["mean", "attn", "lstm", "honet"])
def test_dropout_scope_path_is_flax_s(sets, model, monkeypatch):
    """The JAX package's models fold exactly one static path into the
    dropout key in an apply: the one MergeLayer.forward uses."""
    spgk, _ = sets
    hyper = model == "honet"
    jj = _jax_batch(spgk, hyper)
    enc = jnp.zeros((1, 1), jnp.float32)
    net = (JaxHONet(input_dim=4, hidden_dim=H, dropout=0.5) if hyper else
           JaxNet(input_dim=4, hidden_dim=H, aggrs=model, dropout=0.5))
    params = net.init(jax.random.PRNGKey(0), enc, jj)
    seen = []
    fold = flax_scope._fold_in_static

    def spy(rng, data):
        seen.append(tuple(data))
        return fold(rng, data)

    monkeypatch.setattr(flax_scope, "_fold_in_static", spy)
    net.apply(params, enc, jj, train=True,
              rngs={"dropout": jax.random.PRNGKey(1)})
    assert seen == [DROPOUT_PATH]


class _Inner(nn.Module):
    rate: float

    @nn.compact
    def __call__(self, x, train):
        return nn.Dropout(self.rate, deterministic=not train)(x)


class _Outer(nn.Module):
    """nn.Dropout at the scope path of the JAX package's one Dropout."""

    rate: float

    @nn.compact
    def __call__(self, x, train):
        return _Inner(self.rate, name="affinity_score")(x, train)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_masks_match_flax(dtype, rate):
    x = np.random.default_rng(4).normal(size=(37, 24)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    for key in KEYS:
        want = _Outer(rate).apply({}, jx, True, rngs={"dropout": key})
        got = dropout(tx, rate, prng.as_key(key))
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="key"):
        dropout(tx, rate, None)


def test_merge_layer_drops_what_flax_drops(sets):
    """A training-mode Net forward from a key against JAX's apply with the
    same dropout rng, fp32: the logits agree only if the masks do."""
    spgk, tspgk = sets
    jj = _jax_batch(spgk, False)
    enc = jnp.zeros((1, 1), jnp.float32)
    jnet = JaxNet(input_dim=4, hidden_dim=H, dropout=0.5, key_layout=(8, 3),
                  fused_hidden=False)
    params = jnet.init(jax.random.PRNGKey(0), enc, jj)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jnet.apply(params, enc, jj, train=True,
                                 rngs={"dropout": key}))
    net = Net(4, H, dropout=0.5, key_layout=(8, 3), fused_hidden=False,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    e = np.random.default_rng(2).integers(0, 120, size=(2, 12))
    tj = join_ops.make_keys_join(8, 3, **net.join_outputs(
        torch.device("cpu")))(tspgk.nodes, tspgk.khi, tspgk.klo,
                              tspgk.sizes, torch.as_tensor(e))
    got = net.train()(tj, key=prng.as_key(key))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    off = net(tj, key=prng.as_key(jax.random.PRNGKey(10)))
    assert not np.allclose(off.detach().numpy(), want, rtol=1e-3)


# ------------------------------------------------------------ sampling
def test_sharded_rank_keys_match_jax():
    """Rank r of the seed-sharded sampler walks its block with
    fold_in(PRNGKey(seed), r): `sample_block` so keyed gives JAX's
    sample_gsets_sharded rank for rank (n not a multiple of the ranks)."""
    g, jg = rmat_graph(200, 1000, seed=0), jax_rmat_graph(200, 1000, seed=0)
    seeds = np.arange(190, dtype=np.int32)
    want = jdist.sample_gsets_sharded(jg, seeds, 4, 3, jdist.make_mesh(4),
                                      seed=5)
    per = -(-len(seeds) // 4)
    indptr, _ = device_graph(g, "cpu")
    etab, stab = walk_tables_for(g, 5, "cpu")
    blocks = []
    for r in range(4):
        block = np.zeros(per, np.int32)
        mine = seeds[r * per:(r + 1) * per]
        block[:len(mine)] = mine
        out = walk_ops.sample_block(
            indptr, etab, stab, torch.as_tensor(block), num_walks=4,
            num_steps=3, bucket=13,
            key=prng.fold_in(prng.prng_key(5), r))
        blocks.append([x[:len(mine)].numpy() for x in out])
    for i, k in enumerate(("nodes", "sizes", "khi", "klo")):
        np.testing.assert_array_equal(
            np.concatenate([b[i] for b in blocks]),
            np.asarray(getattr(want, k)).astype(np.uint32).view(np.int32),
            err_msg=k)


# ------------------------------------------------------------ the fits
@pytest.mark.parametrize("model", ["mean", "honet"])
def test_fit_with_dropout_matches_jax(sets, model):
    """Two epochs at dropout 0.1 in float32 from the same weights and
    JAX's key: JAX's batch order and JAX's masks, so JAX's fit."""
    spgk, tspgk = sets
    hyper = model == "honet"
    rng = np.random.default_rng(33)
    edges = rng.integers(0, 120, size=(3 if hyper else 2, 21)).astype(
        np.int32)
    labels = (rng.random(21) < 0.5).astype(np.float32)
    jnet = (JaxHONet(input_dim=4, hidden_dim=H, dropout=0.1) if hyper
            else JaxNet(input_dim=4, hidden_dim=H, dropout=0.1))
    jtr = jax_trainer(jnet, spgk, JaxTrainConfig(batch_size=BS, lr=LR),
                      **(dict(join_factory=jjoin.make_keys_hjoin)
                         if hyper else {}))
    p0, opt = jtr.init(jax.random.PRNGKey(0), edges[:, :BS])
    key = jax.random.PRNGKey(5)
    p1, _, losses, aucs = jtr.fit(p0, opt, jnp.asarray(edges),
                                  jnp.asarray(labels), key, 2)
    flat = lambda p: params_from_flax(jax.tree.map(np.asarray, p))
    net = (HONet(4, H, dropout=0.1,
                 key=prng.prng_key(0), device="cpu") if hyper
           else Net(4, H, dropout=0.1, key=prng.prng_key(0), device="cpu"))
    net.load_state_dict(flat(p0))
    tr = trainer_from_keys(net, tspgk, TrainConfig(batch_size=BS, lr=LR),
                           **(dict(join_factory=join_ops.make_keys_hjoin)
                              if hyper else {}))
    got_losses, got_aucs = tr.fit(edges, labels, 2, prng.as_key(key))
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=1e-5)
    np.testing.assert_allclose(got_aucs.numpy(), np.asarray(aucs),
                               atol=1e-6)
    want, state0 = flat(p1), flat(p0)
    moved = max(float((want[k] - state0[k]).abs().max()) for k in want)
    assert moved > 3 * LR                               # the fit trained
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
