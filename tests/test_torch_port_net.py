"""PyTorch port, the mean Net: the same flax parameters, converted by
params_from_flax, on the same join. The port's logits (fused route with
the kernel's plain version, and unfused route) against JAX Net with
fused_hidden=False (its XLA path) and fused_hidden=True (Pallas in
interpret mode). Tolerance: rtol = atol = 1e-4 in float32 (sums in other
orders); 3e-2 in bfloat16 (the frameworks round to bf16 at different
points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.graph.synthetic import rmat_graph
from surel_plus_tpu.models import Net as JaxNet
from surel_plus_tpu.ops.join import make_keys_join as jax_make_keys_join
from surel_plus_tpu.ops.sampler import sample_gsets_device_keys
from surel_plus_tpu_torch.convert import params_from_flax
from surel_plus_tpu_torch.models import Net
from surel_plus_tpu_torch.ops import prng
from surel_plus_tpu_torch.ops.join import make_keys_join
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

H = 16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(scope="module", params=[(100, 3), (200, 4)],
                ids=["lo_only", "lead_in_hi"])
def joined(request):
    nw, ns = request.param
    g = rmat_graph(150, 700, seed=13)
    spgk = sample_gsets_device_keys(g, np.arange(150, dtype=np.int32),
                                    num_walks=nw, num_steps=ns, seed=2,
                                    block_size=64)
    edges = np.random.default_rng(14).integers(0, 150, size=(2, 16))
    jj = jax.jit(jax_make_keys_join(nw, ns))(
        spgk.nodes, spgk.khi, spgk.klo, spgk.sizes,
        jnp.asarray(edges, jnp.int32))
    c = lambda x: torch.as_tensor(np.array(x).view(np.int32))
    tj = make_keys_join(nw, ns)(c(spgk.nodes), c(spgk.khi), c(spgk.klo),
                                c(spgk.sizes), torch.as_tensor(edges))
    return nw, ns, jj, tj


def _pair(nw, ns, dtype, jj, **kw):
    jnet = JaxNet(input_dim=ns + 1, hidden_dim=H, aggrs="mean",
                  dropout=0.0, dtype=dtype, key_layout=(nw, ns), **kw)
    feat = None
    if kw.get("use_feature"):
        feat = np.random.default_rng(3).normal(
            size=(2, jj.mask.shape[1], kw["x_dim"])).astype(np.float32)
    enc = jnp.zeros((1, 1), jnp.float32)
    params = jnet.init(jax.random.PRNGKey(0), enc, jj, feat)
    state = params_from_flax(jax.tree.map(np.asarray, params))

    def port(fused):
        net = Net(ns + 1, H, dropout=0.0, dtype=dtype, key_layout=(nw, ns),
                  fused_hidden=fused, key=prng.prng_key(0), device="cpu",
                  **kw)
        net.load_state_dict(state)
        return net.eval()

    def jax_logits(fused):
        return np.asarray(jnet.clone(fused_hidden=fused).apply(
            params, enc, jj, feat))

    return port, jax_logits, feat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_net_logits_match_jax(joined, dtype):
    nw, ns, jj, tj = joined
    port, jax_logits, _ = _pair(nw, ns, dtype, jj)
    want = {f: jax_logits(f) for f in (False, True)}
    tol = TOL[dtype]
    with torch.no_grad():
        for fused in (False, True):
            got = port(fused)(tj).numpy()
            for jf, w in want.items():
                np.testing.assert_allclose(
                    got, w, rtol=tol, atol=tol,
                    err_msg=f"port fused={fused} vs jax fused={jf}")


def test_net_with_features_matches_jax(joined):
    nw, ns, jj, tj = joined
    port, jax_logits, feat = _pair(nw, ns, "float32", jj, use_feature=True,
                                   x_dim=5)
    with torch.no_grad():
        got = port(None)(tj, torch.as_tensor(feat)).numpy()
    np.testing.assert_allclose(got, jax_logits(False), rtol=1e-4, atol=1e-4)


def test_seeded_init_is_reproducible_and_shaped():
    a = Net(4, H, key=prng.prng_key(0), device="cpu")
    b = Net(4, H, key=prng.prng_key(0), device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    assert a.pe_embedding.fc0.weight.shape == (H, 4)
    assert a.affinity_score.fc0.weight.shape == (H, 2 * H)
    assert torch.all(a.affinity_score.fc0.bias == 0)


@pytest.mark.parametrize("aggrs", ["sum"])
def test_unported_aggregators_raise(aggrs):
    with pytest.raises(ValueError, match="unknown aggregator"):
        Net(4, H, aggrs=aggrs, key=prng.prng_key(0), device="cpu")


def test_params_from_flax_rejects_unported_modules():
    """An LSTM aggregator's tree maps onto aggr.wi/wh/bh as it is (flax's
    orientation); a module with no torch counterpart raises."""
    rng = np.random.default_rng(0)
    lstm = {k: rng.normal(size=s).astype(np.float32)
            for k, s in (("wi", (3, 8)), ("wh", (2, 8)), ("bh", (8,)))}
    state = params_from_flax({"params": {"aggr": lstm}})
    assert sorted(state) == ["aggr.bh", "aggr.wh", "aggr.wi"]
    for k, v in lstm.items():
        assert torch.equal(state[f"aggr.{k}"], torch.as_tensor(v))
    with pytest.raises(KeyError, match="decoder"):
        params_from_flax({"params": {"decoder": lstm}})
