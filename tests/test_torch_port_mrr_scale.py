"""PyTorch port, the citation2-scale MRR probe (`surel_plus_tpu_torch/cli/
probe_mrr_scale.py`, the port of `scripts/probe_mrr_scale.py`), held to
the JAX package at toy size, and `trainer_from_keys`' `train_embed_mode`.

- The module's draws equal a numpy replay of the script's loop
  (probe_mrr_scale.py:53-58, 79-86), chunk by chunk, at two chunk sizes.
- A toy `run` on the CPU (float32) scores what the script's calls score
  in the JAX package: the same sets exactly, the positives' and
  negatives' scores within 1e-5 of JAX's `trainer_from_keys(...).init(
  PRNGKey(0), init_edges)` / `predict` (the XLA route,
  `fused_hidden=False`), the MRR within 1e-6 of JAX's `device_mrr` on
  those scores.
- Asked for the card where there is none, `run` and `main` raise.
- `trainer_from_keys(..., train_embed_mode="direct")` and `"table"` give
  the default's losses over two epochs on the keys path, and JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph as jax_rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys as jax_sample
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import device_mrr as jax_device_mrr
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.cli import probe_mrr_scale as probe
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import trainer_from_keys
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOY = dict(num_nodes=2000, num_edges=12000, M=8, S=2, n_src=64, k_neg=10,
           chunk=200, batch=256)
SCORE_ATOL = 1e-5
MRR_ATOL = 1e-6
LOSS_RTOL = 1e-5                  # tests/test_torch_port_train.py's fit
KEYS = ("nodes", "khi", "klo", "sizes")


def _script_draws(num_nodes, n_src, k_neg, chunk):
    """The script's draws, its lines replayed: init edges, src, pos_dst,
    then each chunk's negatives."""
    rng = np.random.default_rng(0)
    init_edges = rng.integers(0, num_nodes, size=(2, 4096)).astype(np.int32)
    src = rng.integers(0, num_nodes, n_src).astype(np.int32)
    pos_dst = rng.integers(0, num_nodes, n_src).astype(np.int32)
    pos_edges = np.stack([src, pos_dst])
    CH = chunk
    negs = []
    for lo in range(0, n_src, CH // k_neg):
        hi = min(lo + CH // k_neg, n_src)
        ns = np.repeat(src[lo:hi], k_neg)
        nd = rng.integers(0, num_nodes, (hi - lo) * k_neg).astype(np.int32)
        negs.append(np.stack([ns, nd]))
    return init_edges, pos_edges, negs


@pytest.mark.parametrize("chunk", [200, 7_000])
def test_draws_match_the_script(chunk):
    """Chunks of 20 sources (the last one short at 64 sources) and of
    700 sources (one chunk)."""
    n, n_src, k = 50_000, 64, 10
    init_w, pos_w, negs_w = _script_draws(n, n_src, k, chunk)
    init_g, pos_g, negs_g = probe.probe_draws(n, n_src, k, chunk)
    np.testing.assert_array_equal(init_g, init_w)
    np.testing.assert_array_equal(pos_g, pos_w)
    negs_g = list(negs_g)
    assert len(negs_g) == len(negs_w) == -(-n_src // (chunk // k))
    for got, want in zip(negs_g, negs_w):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="holds no source"):
        probe.probe_draws(n, n_src, k, chunk=k - 1)


@pytest.fixture(scope="module")
def toy_run():
    return probe.run(**TOY, dtype="float32", device="cpu",
                     log=lambda msg: None)


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/probe_mrr_scale.py's calls at TOY's size, Net in float32
    on the XLA route."""
    g = jax_rmat_graph(TOY["num_nodes"], TOY["num_edges"], seed=0)
    spgk = jax_sample(g, np.arange(TOY["num_nodes"], dtype=np.int32),
                      num_walks=TOY["M"], num_steps=TOY["S"], seed=0)
    model = JaxNet(input_dim=TOY["S"] + 1, hidden_dim=96, dropout=0.1,
                   dtype="float32", fused_hidden=False)
    tr = jax_trainer(model, spgk, JaxTrainConfig(batch_size=TOY["batch"],
                                                 lr=1e-3))
    init_edges, pos_edges, negs = _script_draws(
        TOY["num_nodes"], TOY["n_src"], TOY["k_neg"], TOY["chunk"])
    params, _ = tr.init(jax.random.PRNGKey(0), init_edges)
    pos = tr.predict(params, pos_edges)
    neg = jnp.concatenate([tr.predict(params, e).reshape(-1, TOY["k_neg"])
                           for e in negs])
    return spgk, np.asarray(pos), np.asarray(neg), float(
        jax_device_mrr(pos, neg))


def test_probe_matches_jax(toy_run, jax_probe):
    spgk, pos, neg, mrr = jax_probe
    sets = toy_run["trainer"].sets
    for k in KEYS:
        np.testing.assert_array_equal(
            getattr(sets, k).numpy(), np.asarray(getattr(spgk, k)).view(
                np.int32), err_msg=k)
    assert toy_run["pos"].shape == (TOY["n_src"],)
    assert toy_run["neg"].shape == (TOY["n_src"], TOY["k_neg"])
    np.testing.assert_allclose(toy_run["pos"].numpy(), pos, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(toy_run["neg"].numpy(), neg, rtol=0,
                               atol=SCORE_ATOL)
    assert abs(toy_run["mrr"] - mrr) <= MRR_ATOL
    assert 0 < toy_run["mrr"] <= 1
    assert toy_run["pairs"] == TOY["n_src"] * (TOY["k_neg"] + 1)
    assert toy_run["seconds"] > 0 and toy_run["peak_gb"] is None


def test_probe_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SUREL_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run(**TOY, device="cuda", log=lambda msg: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run(**TOY, log=lambda msg: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(["--n_src", "4"])
    monkeypatch.setenv("SUREL_PLATFORM", "cpu")
    assert probe.resolve_device(None) == torch.device("cpu")


def test_train_embed_mode_changes_nothing_on_keys(toy_run, jax_probe):
    """Two epochs of dropout-0.1 fits from flax's init: the port's default,
    "table" and "direct" equal, and JAX's "direct" (bench_1m_remat.py's
    call form) within the fit tolerance."""
    sets = toy_run["trainer"].sets
    rng = np.random.default_rng(3)
    q = rng.integers(0, TOY["num_nodes"], size=(2, 512)).astype(np.int32)
    labels = (rng.random(512) < 0.5).astype(np.float32)
    cfg = TrainConfig(batch_size=TOY["batch"], lr=1e-3)
    losses = {}
    for mode in (None, "table", "direct"):
        kw = {} if mode is None else dict(train_embed_mode=mode)
        tr = trainer_from_keys(probe.Net(TOY["S"] + 1, 96, dropout=0.1,
                                         key=None, device="cpu"),
                               sets, cfg, **kw)
        tr.init(prng.prng_key(0))
        losses[mode] = tr.fit(q, labels, 2, prng.prng_key(1))[0].numpy()
    np.testing.assert_array_equal(losses["table"], losses[None])
    np.testing.assert_array_equal(losses["direct"], losses[None])

    jtr = jax_trainer(JaxNet(input_dim=TOY["S"] + 1, hidden_dim=96,
                             dropout=0.1, fused_hidden=False),
                      jax_probe[0], JaxTrainConfig(batch_size=TOY["batch"],
                                                   lr=1e-3),
                      train_embed_mode="direct")
    params, opt_state = jtr.init(jax.random.PRNGKey(0), q[:, :TOY["batch"]])
    _, _, jlosses, _ = jtr.fit(params, opt_state, jnp.asarray(q),
                               jnp.asarray(labels), jax.random.PRNGKey(1), 2)
    np.testing.assert_allclose(losses[None], np.asarray(jlosses),
                               rtol=LOSS_RTOL)
