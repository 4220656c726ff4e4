"""PyTorch port, the serving slice end to end: a small RMAT graph sampled
by the JAX package, its SpGKeys carried across, and the same flax
parameters scored by JAX `trainer_from_keys(...).predict` and by the
port's, in the lo-only (M=100, S'=3) and the lead-in-hi (M=200, S'=4)
layouts. Scores: float32, rtol = atol = 1e-5 (sigmoid of logits that agree
to 1e-4, see test_torch_port_net.py). The ranking metrics, fed the same
scores, must agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu.train import TrainConfig as JaxTrainConfig
from surel_plus_tpu.train.device import device_hits_at_k as jax_hits
from surel_plus_tpu.train.device import device_mrr as jax_mrr
from surel_plus_tpu.train.device import trainer_from_keys as jax_trainer
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.spg import SpGKeys
from surel_plus_tpu_torch.train import TrainConfig
from surel_plus_tpu_torch.train.device import (
    device_hits_at_k,
    device_mrr,
    trainer_from_keys,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

H, N, BS, E = 16, 120, 8, 21     # E % BS != 0: the tail batch is padded


@pytest.fixture(scope="module", params=[(100, 3), (200, 4)],
                ids=["lo_only", "lead_in_hi"])
def scored(request):
    nw, ns = request.param
    g = rmat_graph(N, 600, seed=21)
    spgk = sample_gsets_device_keys(g, np.arange(N, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=5,
                                    block_size=64)
    edges = np.random.default_rng(22).integers(0, N, size=(2, E)).astype(
        np.int32)
    jtr = jax_trainer(JaxNet(input_dim=ns + 1, hidden_dim=H, dropout=0.0),
                      spgk, JaxTrainConfig(batch_size=BS))
    params, _ = jtr.init(jax.random.PRNGKey(0), edges[:, :BS])
    want = np.asarray(jtr.predict(params, edges))
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    tspgk = SpGKeys(nodes=c(spgk.nodes), khi=c(spgk.khi), klo=c(spgk.klo),
                    sizes=c(spgk.sizes), num_walks=nw, num_steps=ns)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    return ns, tspgk, edges, state, want


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_predict_matches_jax(scored, fused):
    ns, tspgk, edges, state, want = scored
    net = Net(ns + 1, H, dropout=0.0, fused_hidden=fused,
              key=prng.prng_key(0), device="cpu")
    net.load_state_dict(state)
    tr = trainer_from_keys(net, tspgk, TrainConfig(batch_size=BS))
    got = tr.predict(edges)
    assert got.shape == (E,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k", [(4, 5), (37, 100)])
def test_ranking_metrics_match_jax_exactly(n, k):
    """Scores rounded to a coarse grid so that ties occur: hits uses a
    strict > against the k-th best negative, MRR counts ties against the
    positive (neg >= pos). Each source's reciprocal rank (the MRR of one
    row) must match exactly; the mean over rows may differ by float32
    rounding (rtol 1e-6), since the frameworks sum in different orders."""
    rng = np.random.default_rng(n * k)
    pos = np.round(rng.random(n), 1).astype(np.float32)
    neg = np.round(rng.random((n, k)), 1).astype(np.float32)
    tp, tn = torch.as_tensor(pos), torch.as_tensor(neg)
    jp, jn = jnp.asarray(pos), jnp.asarray(neg)
    for i in range(n):
        assert device_mrr(tp[i:i + 1], tn[i:i + 1]).item() == float(
            jax_mrr(jp[i:i + 1], jn[i:i + 1])), i
    np.testing.assert_allclose(device_mrr(tp, tn).item(),
                               float(jax_mrr(jp, jn)), rtol=1e-6)
    for kk in (1, 3, n * k, n * k + 1):
        assert device_hits_at_k(tp, tn.reshape(-1), kk).item() == float(
            jax_hits(jnp.asarray(pos), jnp.asarray(neg.reshape(-1)), kk)), kk
