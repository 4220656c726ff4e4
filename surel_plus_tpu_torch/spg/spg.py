"""Sampled set stores (port of surel_plus_tpu/spg/spg.py: SpG, SpGDevice,
SpGKeys).

The padded-dense layout: row u holds set S_u, nodes ascending and padded
with INT32_MAX. The encoding-table stores (SpG on the host, SpGDevice on a
torch device) keep each slot's 1-based index into a deduplicated table of
landing-count encodings whose row 0 is all zero (0 = padding / absent);
the packed-key store (SpGKeys) keeps each slot's packed key instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SpG:
    """Host (numpy) encoding-table store. Rows are keyed by position in
    `seeds`; `row_lookup` maps node id -> row."""

    nodes: np.ndarray   # int32 [n, L], ascending per row, pad INT32_MAX
    eidx: np.ndarray    # int32 [n, L], 0 = absent
    sizes: np.ndarray   # int32 [n]
    enc: np.ndarray     # int32 [U+1, ncol] landing counts, row 0 = zeros
    seeds: np.ndarray   # int32 [n] node id of each row
    num_walks: int
    num_steps: int      # walk steps S' (ncol = S' + 1)
    _row_lookup: Optional[np.ndarray] = None

    @property
    def num_rows(self) -> int:
        return self.nodes.shape[0]

    @property
    def bucket(self) -> int:
        return self.nodes.shape[1]

    @property
    def ncol(self) -> int:
        return self.enc.shape[1]

    @property
    def num_unique_enc(self) -> int:
        return self.enc.shape[0] - 1

    def row_lookup(self, num_nodes: Optional[int] = None) -> np.ndarray:
        """int32[num_nodes] mapping node id -> SpG row (-1 if unsampled)."""
        if self._row_lookup is None:
            if num_nodes is None:
                num_nodes = int(self.seeds.max()) + 1
            lut = np.full(num_nodes, -1, dtype=np.int32)
            lut[self.seeds] = np.arange(self.num_rows, dtype=np.int32)
            self._row_lookup = lut
        return self._row_lookup

    def enc_normalized(self, dtype=np.float32) -> np.ndarray:
        """Encoding table as landing probabilities (raw counts divided by
        num_walks, as the model reads them)."""
        return self.enc.astype(dtype) / dtype(self.num_walks)

    def device(self, device="cuda") -> "SpGDevice":
        """The padded arrays as tensors on `device`, enc normalized."""
        t = lambda a: torch.as_tensor(a).to(device)
        return SpGDevice(nodes=t(self.nodes), eidx=t(self.eidx),
                         sizes=t(self.sizes), enc=t(self.enc_normalized()))

    def to_scipy(self, num_nodes: Optional[int] = None):
        """The reference's CSR form (sampler/random_walks.py:79): row u =
        S_u, each member's value its 1-based encoding index; a scipy
        csr_matrix [num_nodes, num_nodes], by default one past the
        largest seed or member."""
        import scipy.sparse as sp

        if num_nodes is None:
            num_nodes = int(max(self.seeds.max(), self.nodes[
                self.nodes < np.iinfo(np.int32).max].max())) + 1
        valid = np.arange(self.bucket)[None, :] < self.sizes[:, None]
        rows = np.repeat(self.seeds, self.sizes.astype(np.int64))
        return sp.csr_matrix((self.eidx[valid], (rows, self.nodes[valid])),
                             shape=(num_nodes, num_nodes))


@dataclasses.dataclass
class SpGDevice:
    """Device-resident encoding-table store: enc normalized to float32."""

    nodes: torch.Tensor   # int32 [n, L] ascending, pad INT32_MAX
    eidx: torch.Tensor    # int32 [n, L], 0 = absent
    sizes: torch.Tensor   # int32 [n]
    enc: torch.Tensor     # float32 [W+1, ncol], row 0 = zeros; rows past
    #                       the u unique encodings are zeros too


@dataclasses.dataclass
class SpGKeys:
    """Sampled sets with each slot's packed landing-count key.

    Keys are unsigned 32-bit words held as int32 bit patterns (torch has
    no full uint32 arithmetic); `ops.walk.u32` reads them back as int64.
    Key 0 is the zero encoding (an absent partner).
    """

    nodes: torch.Tensor   # int32 [n, L] ascending, pad INT32_MAX
    khi: torch.Tensor     # int32 bits [n, L]
    klo: torch.Tensor     # int32 bits [n, L]
    sizes: torch.Tensor   # int32 [n]
    num_walks: int
    num_steps: int
