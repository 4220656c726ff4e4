"""PyTorch port, graph files (`graph/io.py`) against the JAX package's
graph/io.py: the edge-list and npz round trips, files written by one
package read by the other (the same CSR arrays), and
`check_int32_capacity` raising where JAX's raises."""

import numpy as np
import pytest

from surel_plus_tpu.graph import io as jio
from surel_plus_tpu.graph.csr import CSRGraph as JaxCSRGraph
from surel_plus_tpu_torch.graph import io as tio
from surel_plus_tpu_torch.graph import rmat_graph
from surel_plus_tpu_torch.graph.csr import CSRGraph
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assert_same(g, w):
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    assert g.indptr.dtype == w.indptr.dtype
    assert g.indices.dtype == w.indices.dtype
    if w.data is None:
        assert g.data is None
    else:
        np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("symmetrize", [True, False])
def test_edgelist_matches_jax(tmp_path, symmetrize):
    p = tmp_path / "g.edgelist"
    # a third column (a weight) is ignored
    p.write_text("# comment\n0 1 1\n1 2 7\n2 0 1\n3 0 2\n# tail\n5 3 1\n")
    g = tio.load_edgelist(str(p), symmetrize=symmetrize)
    assert g.num_nodes == 6
    assert g.has_edge(3, 0) and g.has_edge(1, 2)
    assert g.has_edge(1, 0) == symmetrize
    _assert_same(g, jio.load_edgelist(str(p), symmetrize=symmetrize))


@pytest.mark.parametrize("weighted", [False, True])
def test_npz_round_trip_across_packages(tmp_path, weighted):
    g = rmat_graph(100, 400, seed=0)
    if weighted:
        g = CSRGraph(indptr=g.indptr, indices=g.indices,
                     data=np.linspace(0.5, 2.0, g.num_edges,
                                      dtype=np.float32))
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save_graph_npz(ours, g)
    jio.save_graph_npz(theirs, JaxCSRGraph(indptr=g.indptr,
                                           indices=g.indices, data=g.data))
    for path in (ours, theirs):
        _assert_same(tio.load_graph_npz(path), g)
        _assert_same(tio.load_graph_npz(path), jio.load_graph_npz(path))


class _Huge:
    """A graph that reports an edge count without holding the edges."""

    def __init__(self, num_edges):
        self.num_edges = num_edges


@pytest.mark.parametrize("num_edges,raises", [
    (0, False), (2 ** 31 - 2, False), (2 ** 31 - 1, True), (2 ** 33, True)])
def test_check_int32_capacity_matches_jax(num_edges, raises):
    g = _Huge(num_edges)
    for check in (tio.check_int32_capacity, jio.check_int32_capacity):
        if raises:
            with pytest.raises(ValueError, match="int32 capacity"):
                check(g)
        else:
            check(g)
