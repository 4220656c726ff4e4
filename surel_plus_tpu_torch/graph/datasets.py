"""Dataset pipeline for link and relation prediction: raw link data ->
observed and inference graphs, and for hyperedge (triplet) prediction:
triplet splits -> the encoder graph (port of
surel_plus_tpu/graph/datasets.py).

`RawLinkData` is the provider-independent payload; `from_ogb` reads an
OGB linkproppred dataset through the `ogb` package (imported when called,
as the JAX package does), `npz_link_data` reads an export of it,
`fixture_link_data` the committed fixtures,
`synthetic_link_data` builds an OGB-shaped RMAT stand-in. `LinkPropDataset`
masks a share of the train edges as training positives, samples their
negatives and builds the observed graph (the rest of the train edges, and
the valid edges with use_val) and the inference graph. Every draw comes
from the caller's numpy `Generator`, in the JAX package's order.

`DEHyperDataset` holds triplet splits (train triplets, valid and test
triplets with k random-node negatives each) and the pairwise encoder
graph; `synthetic_hyper_data` builds a random one. Their draws are the
JAX package's: the split from numpy's global generator, the training
negatives from the dataset's own `Generator`.

`DEHDataset` holds a relation of the heterogeneous MAG graph (a predicted
relation's splits and the other relation's edges): `from_pickle` reads the
reference's torch pickles, `from_npz` an export of them,
`synthetic_hetero_data` builds a random one. Its draws are the JAX
package's, from the caller's `Generator`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np

from surel_plus_tpu_torch.graph.csr import (
    CSRGraph,
    coalesce_edge_list,
    csr_from_edges,
)
from surel_plus_tpu_torch.graph.negative import negative_sampling
from surel_plus_tpu_torch.graph.synthetic import rmat_graph

log = logging.getLogger(__name__)

# the committed fixtures, read where the JAX package keeps them (data, not
# code: nothing of that package is imported)
FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "surel_plus_tpu", "data", "fixtures")


@dataclasses.dataclass
class RawLinkData:
    """Provider-independent raw payload: graph edge_index, per-split query
    edges (OGB layout), features."""

    edge_index: np.ndarray            # [2, E] graph edges (as loaded)
    split_edge: Dict                  # OGB-layout split dict
    num_nodes: int
    x: Optional[np.ndarray] = None    # [N, F] features
    edge_weight: Optional[np.ndarray] = None
    directed: bool = False


def from_ogb(name: str) -> RawLinkData:
    """Load an OGB linkproppred dataset through the `ogb` package
    (`PygLinkPropPredDataset`, which downloads it when it is not on
    disk); raises ImportError where `ogb` is not installed, as the JAX
    package's `from_ogb` does."""
    from ogb.linkproppred import PygLinkPropPredDataset

    ds = PygLinkPropPredDataset(name=name)
    graph = ds[0]
    x = graph["x"].numpy() if "x" in graph else None
    num_nodes = (x.shape[0] if x is not None
                 else int(graph["edge_index"].max()) + 1)
    se = _torch_split_to_numpy(ds.get_edge_split())
    ew = (graph["edge_weight"].numpy().reshape(-1)
          if "edge_weight" in graph else None)
    return RawLinkData(edge_index=graph["edge_index"].numpy(),
                       split_edge=se, num_nodes=num_nodes, x=x,
                       edge_weight=ew,
                       directed="source_node" in se["train"])


def _torch_split_to_numpy(split_edge) -> Dict:
    """OGB's split dict of tensors -> the same dict of numpy arrays."""
    return {split: {k: np.asarray(v) for k, v in d.items()}
            for split, d in split_edge.items()}


def npz_link_data(path: str) -> RawLinkData:
    """Load a RawLinkData npz export (`--dataset npz:<path>`).

    Two layouts are accepted:

    Hits-style (collab/ppa/ddi/vessel):
      train_edge [E,2], valid_edge/test_edge [Ev,2],
      valid_neg/test_neg [En,2], num_nodes; optional train_weight/
      valid_weight/test_weight [E], x [N,F].

    MRR-style (citation2 — directed, per-source negatives):
      train_src/train_dst [E], valid_src/valid_dst/test_src/test_dst,
      valid_neg/test_neg [Ev, k] (target_node_neg), num_nodes;
      optional x.
    """
    z = np.load(path)
    num_nodes = int(z["num_nodes"])
    x = np.asarray(z["x"]) if "x" in z.files else None
    if "train_src" in z.files:  # MRR-style (directed)
        split_edge = {
            "train": {"source_node": np.asarray(z["train_src"]),
                      "target_node": np.asarray(z["train_dst"])},
            "valid": {"source_node": np.asarray(z["valid_src"]),
                      "target_node": np.asarray(z["valid_dst"]),
                      "target_node_neg": np.asarray(z["valid_neg"])},
            "test": {"source_node": np.asarray(z["test_src"]),
                     "target_node": np.asarray(z["test_dst"]),
                     "target_node_neg": np.asarray(z["test_neg"])},
        }
        edge_index = np.stack([np.asarray(z["train_src"]),
                               np.asarray(z["train_dst"])]).astype(
                                   np.int64)
        return RawLinkData(edge_index=edge_index, split_edge=split_edge,
                           num_nodes=num_nodes, x=x, directed=True)
    train_e = np.asarray(z["train_edge"], dtype=np.int64)
    has_w = "train_weight" in z.files
    split_edge = {
        "train": {"edge": train_e},
        "valid": {"edge": np.asarray(z["valid_edge"], dtype=np.int64),
                  "edge_neg": np.asarray(z["valid_neg"], dtype=np.int64)},
        "test": {"edge": np.asarray(z["test_edge"], dtype=np.int64),
                 "edge_neg": np.asarray(z["test_neg"], dtype=np.int64)},
    }
    if has_w:
        split_edge["train"]["weight"] = z["train_weight"]
        for s in ("valid", "test"):
            key = f"{s}_weight"
            if key in z.files:
                split_edge[s]["weight"] = z[key]
    return RawLinkData(
        edge_index=train_e.T,
        split_edge=split_edge,
        num_nodes=num_nodes,
        x=x,
        edge_weight=np.asarray(z["train_weight"]) if has_w else None,
        directed=False,
    )


def fixture_link_data(name: str = "collab") -> RawLinkData:
    """Load a committed recorded-split fixture (`collabs`, `collab`,
    `cites`) from FIXTURE_DIR."""
    return npz_link_data(os.path.join(FIXTURE_DIR, f"{name}_fixture.npz"))


def synthetic_link_data(
    num_nodes: int = 2000,
    num_edges: int = 8000,
    seed: int = 0,
    val_frac: float = 0.05,
    test_frac: float = 0.05,
    num_feature: int = 0,
    mrr_style: bool = False,
    neg_per_query: int = 50,
) -> RawLinkData:
    """OGB-shaped synthetic data: an RMAT graph split into train/valid/test
    query edges with sampled evaluation negatives."""
    rng = np.random.default_rng(seed)
    g = rmat_graph(num_nodes, num_edges, seed=seed)
    # unique undirected edges (u < v), in the CSR's row-major order
    row = np.repeat(np.arange(g.num_nodes), g.degrees())
    keep = row < g.indices
    edges = np.stack([row[keep], g.indices[keep]]).astype(np.int64)
    E = edges.shape[1]
    perm = rng.permutation(E)
    n_val, n_test = int(E * val_frac), int(E * test_frac)
    test_e = edges[:, perm[:n_test]]
    val_e = edges[:, perm[n_test:n_test + n_val]]
    train_e = edges[:, perm[n_test + n_val:]]

    if mrr_style:
        split_edge = {
            "train": {"source_node": train_e[0], "target_node": train_e[1]},
            "valid": {"source_node": val_e[0], "target_node": val_e[1],
                      "target_node_neg": rng.integers(
                          0, num_nodes, size=(n_val, neg_per_query))},
            "test": {"source_node": test_e[0], "target_node": test_e[1],
                     "target_node_neg": rng.integers(
                         0, num_nodes, size=(n_test, neg_per_query))},
        }
    else:
        split_edge = {
            "train": {"edge": train_e.T},
            "valid": {"edge": val_e.T,
                      "edge_neg": negative_sampling(
                          edges, num_nodes, n_val * 2, rng=rng).T},
            "test": {"edge": test_e.T,
                     "edge_neg": negative_sampling(
                         edges, num_nodes, n_test * 2, rng=rng).T},
        }
    x = (rng.standard_normal((num_nodes, num_feature)).astype(np.float32)
         if num_feature else None)
    return RawLinkData(edge_index=train_e, split_edge=split_edge,
                       num_nodes=num_nodes, x=x,
                       directed=mrr_style)


class LinkPropDataset:
    """Observed-graph construction with edge masking, negative sampling,
    and use_val inference-graph merging."""

    def __init__(self, raw: RawLinkData, mask_ratio: float = 0.05,
                 k: int = 10, use_weight: bool = False,
                 use_coalesce: bool = False, use_feature: bool = False,
                 use_val: bool = False, rng: Optional[np.random.Generator]
                 = None, vessel_mode: bool = False):
        self.raw = raw
        self.mask_ratio = mask_ratio
        self.k = k
        self.use_weight = use_weight and raw.edge_weight is not None
        self.use_coalesce = use_coalesce
        self.use_feature = use_feature
        self.use_val = use_val
        self.vessel_mode = vessel_mode
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.num_nodes = raw.num_nodes
        self.num_feature = raw.x.shape[1] if raw.x is not None else 0

        if raw.directed:
            # citation2-style: the full graph edge list is the train edge
            # pool
            self.train_edge = raw.edge_index.T.copy()     # [E, 2]
        else:
            self.train_edge = np.asarray(
                raw.split_edge["train"]["edge"], dtype=np.int64)
        self.train_weight = (np.asarray(raw.edge_weight)
                             if self.use_weight else None)
        if self.use_weight and use_coalesce:
            # the reference coalesces the train edge list BEFORE the mask
            # split: this changes which edges get masked, not just the
            # weights
            self.train_edge, self.train_weight = coalesce_edge_list(
                self.train_edge, self.train_weight)
        self.len_train = len(self.train_edge)

        if use_feature and raw.x is not None and vessel_mode:
            # vessel column-normalizes features
            norms = np.linalg.norm(raw.x, axis=0, keepdims=True)
            self.x = raw.x / np.maximum(norms, 1e-12)
        else:
            self.x = raw.x

    def process(self, logger=None) -> Dict[str, CSRGraph]:
        lg = logger or log
        lg.info("node size %d, feature dim %d, edge size %d, mask %.3f",
                self.num_nodes, self.num_feature, self.len_train,
                self.mask_ratio)

        if self.vessel_mode:
            pos_edge, obsrv_edge, idx = self._vessel_split()
            force_undirected = True
        else:
            self.num_pos = int(self.len_train * self.mask_ratio)
            idx = self.rng.permutation(self.len_train)
            pos_edge = self.train_edge[idx[:self.num_pos]]
            obsrv_edge = self.train_edge[idx[self.num_pos:]]
            force_undirected = False
        self.pos_edge = pos_edge

        # negatives indexed by the same permutation prefix: the reference's
        # selection quirk
        neg = negative_sampling(
            self.raw.edge_index, num_nodes=self.num_nodes,
            num_neg_samples=self.len_train + 1, rng=self.rng,
            force_undirected=force_undirected)
        take = idx[:min(self.num_pos * self.k, self.len_train)]
        self.neg_edge = neg[:, take].T

        obsrv_w = (self.train_weight[idx[self.num_pos:]]
                   if self.use_weight else None)
        val_w = self.train_weight if self.use_weight else None

        val_edge = self.train_edge
        if self.use_val:
            valid_e = np.asarray(self.raw.split_edge["valid"]["edge"],
                                 dtype=np.int64)
            obsrv_edge = np.concatenate([obsrv_edge, valid_e])
            inf_edge = np.concatenate([self.train_edge, valid_e])
            if self.use_weight:
                vw = np.asarray(self.raw.split_edge["valid"]["weight"])
                obsrv_w = np.concatenate([obsrv_w, vw])
                inf_w = np.concatenate([val_w, vw])
            else:
                inf_w = None
        else:
            inf_edge, inf_w = None, None

        n = self.num_nodes
        # always coalesce at CSR build (the reference's scipy csr_matrix
        # sums duplicate entries); use_coalesce only governs the edge-list
        # coalescing in __init__
        G_obsrv = csr_from_edges(obsrv_edge, num_nodes=n, weights=obsrv_w,
                                 coalesce=True)
        G_val = csr_from_edges(val_edge, num_nodes=n, weights=val_w)
        if self.use_val:
            G_full = csr_from_edges(inf_edge, num_nodes=n, weights=inf_w)
        else:
            G_full = G_val

        lg.info("observed graph: %d nodes, %d (sym) edges",
                int((G_obsrv.degrees() > 0).sum()), G_obsrv.num_edges // 2)
        return {"train": G_obsrv, "val": G_val, "test": G_full}

    def _vessel_split(self):
        """3-hop-subgraph positive masking around low-degree nodes."""
        e = self.train_edge
        deg = np.bincount(e[:, 0], minlength=self.num_nodes)
        order = np.argsort(deg, kind="stable")
        target = order[deg[order] > 0]
        pick = self.rng.permutation(len(target))
        seeds = target[pick[:int(self.len_train * self.mask_ratio)]]
        # 3-hop BFS node closure over the (undirected) edge list
        in_hop = np.zeros(self.num_nodes, dtype=bool)
        in_hop[seeds] = True
        for _ in range(3):
            touched = in_hop[e[:, 0]] | in_hop[e[:, 1]]
            in_hop[e[touched, 0]] = True
            in_hop[e[touched, 1]] = True
        edge_mask = in_hop[e[:, 0]] & in_hop[e[:, 1]]
        self.num_pos = int(edge_mask.sum())
        return e[edge_mask], e[~edge_mask], self.rng.permutation(
            self.len_train)


class DEHDataset:
    """Heterogeneous relation-prediction data: MAG author-writes-paper and
    paper-cites-paper (the reference's dataloader.py:155-238). Node ids of
    all types share one id space, as in the reference's pickles.

    `process` masks a share of the predicted relation's train edges as
    training positives and samples their negatives; the observed graph is
    the rest of those edges and the other relation's (`obsrv_edge`), the
    inference graph all of both."""

    def __init__(self, train_edge: np.ndarray, obsrv_edge: np.ndarray,
                 split_edge: Dict, num_nodes: int,
                 node_types: Optional[list] = None, mask_ratio: float = 0.05,
                 k: int = 10, rng: Optional[np.random.Generator] = None):
        self.train_edge = np.asarray(train_edge, dtype=np.int64)  # [E, 2]
        self.obsrv_edge = np.asarray(obsrv_edge, dtype=np.int64)
        self.split_edge = split_edge
        self.num_nodes = num_nodes
        self.node_type = node_types or ["node"]
        self.mask_ratio = mask_ratio
        self.k = k
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.num_feature = len(self.node_type)
        self.len_train = len(self.train_edge)

    @staticmethod
    def from_pickle(path: str, relation: str, **kw) -> "DEHDataset":
        """Load the reference's torch pickle (dataloader.py:157-164): a dict
        of 'split_edge', 'num_nodes_dict' and 'edge_index' keyed by
        (src_type, rel, dst_type). `torch.load(path)` with torch's default
        `weights_only`, so this reads, or refuses, what the JAX package's
        loader does."""
        import torch

        data = torch.load(path)
        rel_key = (("author", "writes", "paper") if relation == "cite"
                   else ("paper", "cites", "paper"))
        obsrv = np.asarray(data["edge_index"][rel_key])
        if obsrv.shape[0] == 2:
            obsrv = obsrv.T
        split_edge = {s: {k2: np.asarray(v2) for k2, v2 in d.items()}
                      for s, d in data["split_edge"].items()}
        train_edge = DEHDataset._train_pairs(split_edge)
        num_nodes = int(max(train_edge.max(), obsrv.max())) + 1
        return DEHDataset(train_edge, obsrv, split_edge, num_nodes,
                          node_types=list(data["num_nodes_dict"]), **kw)

    @staticmethod
    def _train_pairs(split_edge: Dict) -> np.ndarray:
        """[E, 2] train pairs from either split layout (the reference
        handles both, dataloader.py:173-178)."""
        train = split_edge["train"]
        if "source_node" in train:
            return np.stack([np.asarray(train["source_node"]),
                             np.asarray(train["target_node"])], axis=1)
        return np.asarray(train["edge"])

    @staticmethod
    def from_npz(path: str, **kw) -> "DEHDataset":
        """Load a MAG relation npz export (`--dataset npz:<path>` with
        'mag' in the file name). Keys: num_nodes, obsrv_edge [E2, 2] (the
        other relation), train_src and train_dst [E], valid_src,
        valid_dst and valid_neg [Qv, k], test_src, test_dst and test_neg
        [Qt, k] (the source-node MRR layout of the MAG pickles);
        optionally node_types (strings)."""
        z = np.load(path)
        split_edge = {
            "train": {"source_node": np.asarray(z["train_src"]),
                      "target_node": np.asarray(z["train_dst"])},
            "valid": {"source_node": np.asarray(z["valid_src"]),
                      "target_node": np.asarray(z["valid_dst"]),
                      "target_node_neg": np.asarray(z["valid_neg"])},
            "test": {"source_node": np.asarray(z["test_src"]),
                     "target_node": np.asarray(z["test_dst"]),
                     "target_node_neg": np.asarray(z["test_neg"])},
        }
        train_edge = DEHDataset._train_pairs(split_edge)
        node_types = ([str(t) for t in z["node_types"]]
                      if "node_types" in z.files else None)
        return DEHDataset(train_edge, np.asarray(z["obsrv_edge"]),
                          split_edge, int(z["num_nodes"]),
                          node_types=node_types, **kw)

    def to_npz(self, path: str) -> None:
        """Write the relation in `from_npz`'s layout (source-node splits)."""
        s = self.split_edge
        np.savez(path, num_nodes=self.num_nodes, obsrv_edge=self.obsrv_edge,
                 node_types=np.asarray(self.node_type),
                 **{f"{split}_{name}": np.asarray(s[split][key])
                    for split in ("train", "valid", "test")
                    for name, key in (("src", "source_node"),
                                      ("dst", "target_node"),
                                      ("neg", "target_node_neg"))
                    if key in s[split]})

    def process(self, logger=None) -> Dict[str, CSRGraph]:
        """Draws, in the JAX package's order, the mask permutation, the
        negatives and their slice, and returns the observed graph
        ("train") and the inference graph ("val", "test")."""
        lg = logger or log
        lg.info("hetero: %d nodes, %d train edges, %d obsrv edges, mask %.3f",
                self.num_nodes, self.len_train, len(self.obsrv_edge),
                self.mask_ratio)
        self.num_pos = int(self.len_train * self.mask_ratio)
        idx = self.rng.permutation(self.len_train)
        self.pos_edge = self.train_edge[idx[:self.num_pos]]
        obsrv_edge = np.concatenate(
            [self.train_edge[idx[self.num_pos:]], self.obsrv_edge])

        neg = negative_sampling(self.train_edge.T, num_nodes=self.num_nodes,
                                num_neg_samples=self.len_train,
                                rng=self.rng)
        take = idx[:min(self.num_pos * self.k, self.len_train)]
        self.neg_edge = neg[:, take].T

        val_edge = np.concatenate([self.train_edge, self.obsrv_edge])
        n = self.num_nodes
        G_obsrv = csr_from_edges(obsrv_edge, num_nodes=n)
        G_val = csr_from_edges(val_edge, num_nodes=n)
        lg.info("observed graph: %d nodes, %d (sym) edges",
                int((G_obsrv.degrees() > 0).sum()), G_obsrv.num_edges // 2)
        return {"train": G_obsrv, "val": G_val, "test": G_val}


def synthetic_hetero_data(num_authors: int = 300, num_papers: int = 500,
                          num_writes: int = 1500, num_cites: int = 2000,
                          relation: str = "cite", seed: int = 0,
                          neg_per_query: int = 20, **kw) -> DEHDataset:
    """MAG-shaped random data: author ids [0, A), paper ids [A, A+P) in one
    id space, uniform 'writes' (author, paper) and 'cites' (paper, paper)
    edges. As in the reference's naming (dataloader.py:162), relation
    'cite' predicts the cites with the writes as the observed relation,
    and any other relation the reverse. A tenth of the predicted edges
    each are the test and the valid queries, with `neg_per_query` random
    target nodes each."""
    rng = np.random.default_rng(seed)
    n = num_authors + num_papers
    writes = np.stack([
        rng.integers(0, num_authors, num_writes),
        rng.integers(num_authors, n, num_writes)], axis=1)
    cites = np.stack([
        rng.integers(num_authors, n, num_cites),
        rng.integers(num_authors, n, num_cites)], axis=1)
    cites = cites[cites[:, 0] != cites[:, 1]]
    pred, obsrv = (cites, writes) if relation == "cite" else (writes, cites)
    perm = rng.permutation(len(pred))
    n_eval = max(len(pred) // 10, 1)
    test_e, val_e, train_e = (pred[perm[:n_eval]],
                              pred[perm[n_eval:2 * n_eval]],
                              pred[perm[2 * n_eval:]])
    split_edge = {
        "train": {"source_node": train_e[:, 0],
                  "target_node": train_e[:, 1]},
        "valid": {"source_node": val_e[:, 0], "target_node": val_e[:, 1],
                  "target_node_neg": rng.integers(
                      0, n, (len(val_e), neg_per_query))},
        "test": {"source_node": test_e[:, 0], "target_node": test_e[:, 1],
                 "target_node_neg": rng.integers(
                     0, n, (len(test_e), neg_per_query))},
    }
    kw.setdefault("rng", np.random.default_rng(seed))
    return DEHDataset(train_e, obsrv, split_edge, n,
                      node_types=["author", "paper"], **kw)


class DEHyperDataset:
    """Hypergraph triplet prediction data (the reference's
    dataloader.py:241-296)."""

    def __init__(self, edge_index: np.ndarray, triplets: Dict,
                 num_nodes: Optional[int] = None, k: int = 10,
                 rng: Optional[np.random.Generator] = None):
        """edge_index: [E, 2] pairwise projection edges, the encoder graph;
        triplets: split dict whose splits hold 'hedge' [T, 3] (and, for
        valid and test, 'hedge_neg' [T k, 3]). rng: the training negatives'
        generator, np.random.default_rng(0) by default (not --seed's, as
        in the JAX package)."""
        self.obsrv_edge = np.asarray(edge_index, dtype=np.int64)
        self.split_edge = triplets
        self.k = k
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.num_nodes = (num_nodes if num_nodes is not None
                          else int(self.obsrv_edge.max()) + 1)
        self.num_feature = 0

    @staticmethod
    def make_edge_split(tuples: np.ndarray, ratio: float = 0.6,
                        k: int = 1000, seed: int = 2021) -> Dict:
        """Train/valid/test triplet split with k random-node negatives per
        eval triplet (dataloader.py:255-269), drawn from numpy's global
        generator after np.random.seed(seed)."""
        np.random.seed(seed)
        tuples = np.asarray(tuples)
        idx = np.random.permutation(len(tuples))
        num_train = int(ratio * len(tuples))
        split = {"train": {"hedge": tuples[idx[:num_train]]}}
        hold = idx[num_train:]
        val_idx, test_idx = hold[:len(hold) // 2], hold[len(hold) // 2:]
        for name, part in (("valid", val_idx), ("test", test_idx)):
            hedge = tuples[part]
            node_neg = np.random.randint(tuples.max(), size=(len(part), k))
            neg = np.concatenate([
                np.repeat(hedge[:, :2], k, axis=0),
                node_neg.reshape(-1, 1)], axis=1)
            split[name] = {"hedge": hedge, "hedge_neg": neg}
        return split

    @staticmethod
    def from_npz(path: str, **kw) -> "DEHyperDataset":
        """Load a hypergraph npz export (`--dataset npz:<path>` of
        cli.main_horder). Keys: num_nodes, edge_index [E, 2] (the pairwise
        encoder-graph projection), train_hedge [T, 3], valid_hedge and
        test_hedge [Tv, 3], valid_neg and test_neg [Tv k, 3]."""
        z = np.load(path)
        triplets = {
            "train": {"hedge": np.asarray(z["train_hedge"])},
            "valid": {"hedge": np.asarray(z["valid_hedge"]),
                      "hedge_neg": np.asarray(z["valid_neg"])},
            "test": {"hedge": np.asarray(z["test_hedge"]),
                     "hedge_neg": np.asarray(z["test_neg"])},
        }
        return DEHyperDataset(np.asarray(z["edge_index"]), triplets,
                              num_nodes=int(z["num_nodes"]), **kw)

    def process(self, logger=None) -> CSRGraph:
        """Draws the training negatives (each train triplet's first two
        nodes with k random third nodes) into pos_hedge [T, 3] and
        neg_hedge [T k, 3], and returns the encoder graph."""
        lg = logger or log
        pos = np.asarray(self.split_edge["train"]["hedge"])
        node_neg = self.rng.integers(0, self.num_nodes,
                                     size=(len(pos), self.k))
        neg = np.concatenate([
            np.repeat(pos[:, :2], self.k, axis=0),
            node_neg.reshape(-1, 1)], axis=1)
        self.pos_hedge = pos
        self.neg_hedge = neg
        lg.info("hypergraph: %d nodes, %d encoder edges, %d train triplets",
                self.num_nodes, len(self.obsrv_edge), len(pos))
        return csr_from_edges(self.obsrv_edge, num_nodes=self.num_nodes)


def synthetic_hyper_data(num_nodes: int = 500, num_triplets: int = 2000,
                         seed: int = 0) -> DEHyperDataset:
    """Random triplets of distinct nodes; the encoder graph is the pairwise
    projection of each triplet (the reference's datasets ship projected
    edge lists)."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, num_nodes, size=(num_triplets, 3))
    tri = tri[(tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
              & (tri[:, 0] != tri[:, 2])]
    edges = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [0, 2]]])
    split = DEHyperDataset.make_edge_split(tri, ratio=0.6, k=20, seed=seed)
    return DEHyperDataset(edges, split, num_nodes=num_nodes,
                          rng=np.random.default_rng(seed))
