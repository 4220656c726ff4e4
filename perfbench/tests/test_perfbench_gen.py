"""The benchmark's generators: the anchored R-MAT edge list against a
NumPy copy of its arithmetic over the same draws, and the queries' and
weights' shapes and determinism."""

import math

import numpy as np
import pytest
import torch

from perfbench.gen import queries as gq
from perfbench.gen.graph import OVERDRAW, generator, rmat_edges

ABC = (0.57, 0.19, 0.19)


def numpy_rmat(n, e, seed, abc, overdraw=OVERDRAW):
    """The same edge list from the same generator's draws, in NumPy."""
    g = generator(seed, "cpu", 1)
    scale = max(1, math.ceil(math.log2(max(n, 2))))
    pa, pb, pc = abc[0], abc[0] + abc[1], sum(abc)

    def pairs(count):
        src = np.zeros(count, np.int64)
        dst = np.zeros(count, np.int64)
        for _ in range(scale):
            r = torch.rand(count, generator=g).numpy()
            src = src * 2 + (r >= pb)
            dst = dst * 2 + (((r >= pa) & (r < pb)) | (r >= pc))
        keep = (src < n) & (dst < n)
        return src[keep], dst[keep]

    def keys(src, dst):
        keep = src != dst
        lo, hi = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
        return np.unique(lo * n + hi)

    relabel = torch.randperm(n, generator=g).numpy()
    partner = np.empty(0, np.int64)
    while partner.size < n:
        _, dst = pairs(int((n - partner.size) * overdraw) + 16)
        partner = np.concatenate([partner, dst])
    fixed = keys(np.arange(n), relabel[partner[:n]])
    uniq = np.empty(0, np.int64)
    need = e - fixed.size
    while uniq.size < need:
        src, dst = pairs(int((need - uniq.size) * overdraw) + 16)
        uniq = np.unique(np.concatenate([uniq, keys(relabel[src],
                                                    relabel[dst])]))
        uniq = uniq[~np.isin(uniq, fixed)]
    pick = torch.randperm(uniq.size, generator=g).numpy()[:need]
    chosen = np.concatenate([fixed, uniq[pick]])
    chosen = chosen[torch.randperm(e, generator=g).numpy()]
    return np.stack([chosen // n, chosen % n], axis=1)


@pytest.mark.parametrize("n,e", [(1000, 6000), (3000, 4000)])
def test_rmat_matches_numpy_copy(n, e):
    got = rmat_edges(n, e, 2**31 + 7, "cpu", ABC).numpy()
    want = numpy_rmat(n, e, 2**31 + 7, ABC)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_rmat_invariants_and_seed():
    e = rmat_edges(500, 3000, 11, "cpu", ABC)
    assert e.shape == (3000, 2)
    assert bool((e[:, 0] < e[:, 1]).all())
    assert bool((e >= 0).all()) and bool((e < 500).all())
    key = e[:, 0].to(torch.int64) * 500 + e[:, 1]
    assert torch.unique(key).numel() == 3000
    assert torch.equal(e, rmat_edges(500, 3000, 11, "cpu", ABC))
    assert not torch.equal(e, rmat_edges(500, 3000, 12, "cpu", ABC))


def test_few_nodes_alone():
    """Every node has its first edge, but those whose partner draw was
    itself: a handful at most."""
    edges = rmat_edges(1000, 3000, 4, "cpu", ABC)
    assert 1000 - torch.unique(edges.reshape(-1)).numel() <= 10


def test_queries_and_weights():
    edges = rmat_edges(300, 1500, 5, "cpu", ABC)
    pos, observed = gq.training_split(edges, 0.05)
    assert pos.shape[0] == 75 and observed.shape[0] == 1425
    q, labels = gq.training_queries(pos, 300, 10, 5)
    assert q.shape == (2, 75 * 11) and labels.sum() == 75
    assert torch.equal(q[:, :75], pos.t().to(torch.int64))
    p, n = gq.ranking_queries(edges, 300, 20, 7, 5)
    assert p.shape == (2, 20) and n.shape == (2, 140)
    assert torch.equal(n[0].reshape(20, 7), p[0][:, None].expand(20, 7))
    w = gq.weights("attn", 4, 96, 5, "cpu")
    assert set(w) == set(gq.weight_shapes("attn", 4, 96))
    assert w["pe_embedding.fc0.weight"].shape == (96, 4)
    again = gq.weights("attn", 4, 96, 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_weights_are_one_model_in_another_order():
    """Two seeds' weights permute the same hidden channels: the same
    values and the same function."""
    a, b = (gq.weights("mean", 4, 96, s, "cpu") for s in (1, 2))
    assert not torch.equal(a["pe_embedding.fc0.bias"],
                           b["pe_embedding.fc0.bias"])
    for k in a:
        assert torch.equal(a[k].flatten().sort().values,
                           b[k].flatten().sort().values)

    def f(w, x):
        h = torch.relu(x @ w["pe_embedding.fc0.weight"].t()
                       + w["pe_embedding.fc0.bias"])
        z = h @ w["pe_embedding.fc1.weight"].t()
        z = torch.relu(torch.cat([z, z], -1)
                       @ w["affinity_score.fc0.weight"].t()
                       + w["affinity_score.fc0.bias"])
        return z @ w["affinity_score.fc1.weight"].t()

    x = torch.rand(50, 4)
    assert torch.allclose(f(a, x), f(b, x), rtol=1e-5, atol=1e-6)
