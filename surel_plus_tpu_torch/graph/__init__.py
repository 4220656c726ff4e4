from surel_plus_tpu_torch.graph.csr import CSRGraph, csr_from_edges
from surel_plus_tpu_torch.graph.synthetic import (
    erdos_renyi,
    ring_of_cliques,
    rmat_graph,
)

__all__ = ["CSRGraph", "csr_from_edges", "erdos_renyi", "ring_of_cliques",
           "rmat_graph"]
