"""Ranking traffic: closed-loop passes over the mix's sources, each with
its positive and `candidates` uniform negatives. A call scores a block
of sources (their positives and candidates, `chunk_batches` batches of
`DeviceTrainer.predict` at the most) and reduces them by `device_mrr`
to the block's MRR (a pass's MRR is the blocks' weighed by their
sources), all on the device.

The check takes one block of the first pass, drawn from the seed: every
score of it against the reference's, and each source's rank, as the
program's `device_mrr` reduces that source's scores from the window,
against the band of ranks that scores within the score limit of the
reference's allow (near ties may fall either way).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from perfbench import drive
from perfbench import trace as tr
from perfbench import work
from perfbench.drive import Check, Readings, free
from perfbench.gen import queries as gq
from perfbench.gen.graph import generator
from perfbench.reference import model as ref
from surel_plus_tpu_torch.train.device import device_mrr


def rank_band(pos: torch.Tensor, neg: torch.Tensor, tie: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lowest, highest) optimistic-tie OGB rank of each positive (a
    negative at or above it counts) that scores allow which each lie
    within `tie` of the reference's `pos` [n] and `neg` [n, K]."""
    d = neg.to(torch.float64) - pos.to(torch.float64)[:, None]
    return 1 + (d >= 2 * tie).sum(dim=1), 1 + (d >= -2 * tie).sum(dim=1)


class Cell(drive.Cell):

    def setup(self) -> None:
        edges = self.edges()
        self.sets = self.sample_sets(edges)
        self.K = int(self.mix["candidates"])
        self.pos, self.neg = gq.ranking_queries(
            edges, self.n, int(self.mix["sources"]), self.K, self.ctx.seed)
        del edges
        self.model(self.sets)
        self.sources = self.pos.shape[1]
        self.per_call = int(self.mix["chunk_batches"]) * self.B // (self.K + 1)
        self.blocks = -(-self.sources // self.per_call)
        g = generator(self.ctx.seed, self.dev, 7)
        self.checked_block = int(torch.randint(
            0, self.blocks, (1,), generator=g, device=self.dev))
        self.checked: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.calls = self._calls()
        # warm up this mix's shapes: a whole block and the last one
        for b in sorted({0, self.blocks - 1}):
            self.score(b)

    def span(self, b: int) -> Tuple[int, int]:
        return b * self.per_call, min(self.sources, (b + 1) * self.per_call)

    def block_edges(self, b: int) -> torch.Tensor:
        """[2, n (1 + K)]: block b's positives, then their candidates."""
        lo, hi = self.span(b)
        return torch.cat([self.pos[:, lo:hi],
                          self.neg[:, lo * self.K:hi * self.K]], dim=1)

    def score(self, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block b's scores and MRR, as the program computes them."""
        lo, hi = self.span(b)
        s = self.trainer.predict(self.block_edges(b))
        return s, device_mrr(s[:hi - lo], s[hi - lo:].reshape(hi - lo,
                                                                self.K))

    def _calls(self):
        passes = 0
        while True:
            for b in range(self.blocks):
                s, mrr = self.score(b)
                lo, hi = self.span(b)
                self.ran.append(b)
                if passes == 0 and b == self.checked_block:
                    self.checked = (s, mrr)
                yield (hi - lo) * (1 + self.K)
            passes += 1

    def step(self) -> None:
        self.work += next(self.calls)

    def finish(self) -> None:
        """Runs the first pass on (untimed) to the checked block, where the
        window ended before it."""
        while self.checked is None:
            next(self.calls)

    def traced_window(self):
        batches = int(self.mix["traced_batches"])
        before = len(self.ran)

        def run():
            done = 0
            while done < batches:
                done += -(-next(self.calls) // self.B)

        out = {}
        self.with_join_span(lambda: out.setdefault(
            "t", tr.traced(run, self.dev)))
        return out["t"], self.ran[before:]

    def pair_counts(self, b: int):
        """(O, H, pairs) of each `predict` batch of block b's call."""
        s = self.sets
        e = self.block_edges(b)
        rows = lambda ids: (s.nodes[ids], s.khi[ids], s.klo[ids],
                            s.sizes[ids])
        out = []
        for lo in range(0, e.shape[1], self.B):
            o, h = work.slot_counts(rows(e[0, lo:lo + self.B]),
                                    rows(e[1, lo:lo + self.B]))
            out.append((float(o.sum()), float(h.sum()), float(o.numel())))
        return out

    def readings(self, window_s: float, window_calls, trace, traced_calls
                 ) -> Readings:
        own = hits = pairs = 0.0
        per_block = {b: self.pair_counts(b) for b in set(window_calls)}
        for b in window_calls:
            for o, h, q in per_block[b]:
                own, hits, pairs = own + o, hits + h, pairs + q
        fwd = work.forward_flops(own, hits, pairs, self.S + 1,
                                 int(self.cfg["hidden_dim"]),
                                 self.cfg["aggregator"])
        counts = [c for b in traced_calls for c in self.pair_counts(b)]
        return Readings("rank", self.cfg, window_s, fwd, trace, len(counts),
                        counts)

    def check(self) -> List[Check]:
        """The checked block: its scores against the reference's, one by
        one, its sources' ranks against the reference's band, and a sample
        of the sets its pairs read."""
        got, _ = self.checked
        pairs = self.block_edges(self.checked_block)
        lo, hi = self.span(self.checked_block)
        n = hi - lo
        # the program's reduction, source by source, on the window's scores
        recip = torch.stack([device_mrr(got[i:i + 1], got[n + i * self.K:
                                                        n + (i + 1) * self.K
                                                        ][None])
                             for i in range(n)]).to(torch.float64)
        ends = torch.unique(pairs.reshape(-1))
        s = self.sets
        rows = (s.nodes[ends], s.khi[ends], s.klo[ends], s.sizes[ends])
        checks = [self.check_sets(s, ends, self.ctx.seed)]
        del self.trainer, self.sets, s, self.checked, self.calls
        free(self.dev)

        def rows_of(nodes):
            at = torch.searchsorted(ends, nodes.to(ends.dtype))
            return tuple(t[at] for t in rows)

        with ref.full_fp32():
            want = ref.scores(rows_of, pairs, self.weights,
                              self.cfg["aggregator"], self.M, self.S)
        checks.append(Check("score_gap", float((got - want).abs().max()),
                            self.limits.get("score_gap", 0.0)))
        low, high = rank_band(want[:n], want[n:].reshape(n, self.K),
                              self.limits.get("score_gap", 0.0))
        rank = 1.0 / recip
        outside = (rank < low - 0.5) | (rank > high + 0.5)
        checks.append(Check("rank_outside_band", float(outside.sum()),
                            self.limits.get("rank_outside_band", 0.0)))
        return checks
