"""Training traffic: closed-loop epochs of `DeviceTrainer.train_epoch`
over the training queries, each epoch's riffle permutation in calls of
`piece_steps` steps (ids past the queries weigh 0).

Set-up drives the one trainer the window gets through one call of the
window's own shape: three steps over three rows of distinct queries, the
last row holding as many padded ids as an epoch's tail holds, the
dropout keys chained from the call's key as in every window call. The
reference follows the three steps.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from perfbench import drive
from perfbench import trace as tr
from perfbench import work
from perfbench.drive import Check, Readings, free, gap, leaf_gap
from perfbench.gen import queries as gq
from perfbench.gen.graph import generator
from perfbench.reference import draws
from perfbench.reference import model as ref
from surel_plus_tpu_torch.train import device as program
from surel_plus_tpu_torch.train.device import riffle_permutation

CHECKED_STEPS = 3


class Cell(drive.Cell):

    def setup(self) -> None:
        edges = self.edges()
        pos, observed = gq.training_split(edges, float(self.mix[
            "train_ratio"]))
        del edges
        self.sets = self.sample_sets(observed)
        self.q_edges, self.labels = gq.training_queries(
            pos, self.n, int(self.cfg["negatives"]), self.ctx.seed)
        del pos
        self.model(self.sets)
        self.E = self.q_edges.shape[1]
        self.first_steps()
        self.pieces = self._pieces()

    def check_perm(self) -> torch.Tensor:
        """[3, B] query ids of the checked call: distinct queries drawn
        from the seed, the last row ending in the epoch's padded ids (as
        many as an epoch's rows hold past the queries, at least one), in
        an order drawn from the seed."""
        g = generator(self.ctx.seed, self.dev, 5)
        n = CHECKED_STEPS * self.B
        pad = min(max(-self.E % self.B, 1), self.B)
        real = torch.randperm(self.E, generator=g, device=self.dev)[:n - pad]
        perm = torch.cat([real, self.E + torch.arange(pad, device=self.dev)]
                         ).reshape(CHECKED_STEPS, self.B)
        last = torch.randperm(self.B, generator=g, device=self.dev)
        perm[-1] = perm[-1][last]
        return perm

    def first_steps(self) -> None:
        """The checked call: keeps each step's loss as the program's
        `batch_loss` returns it, the call's mean loss, the first gradient
        as Adam holds it after the first step, and the parameters after
        the third."""
        self.check_ids = self.check_perm()
        self.check_key = draws.fold_in(draws.key_of(self.ctx.seed), 100)
        net = self.trainer.model
        opt = self.trainer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        names = {p: k for k, p in net.named_parameters()}
        self.g1 = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
        steps: List[torch.Tensor] = []
        loss_of = program.batch_loss

        def kept_loss(*a, **k):
            out = loss_of(*a, **k)
            steps.append(out.detach().clone())
            return out

        def first_step(optimizer, args, kwargs):
            if len(steps) == 1:
                for p, st in optimizer.state.items():
                    self.g1[names[p]] = (st["exp_avg"] / (1 - beta1)).clone()

        hook = opt.register_step_post_hook(first_step)
        program.batch_loss = kept_loss
        try:
            loss, _ = self.trainer.train_epoch(
                self.q_edges, self.labels, self.check_key,
                perm=self.check_ids)
        finally:
            program.batch_loss = loss_of
            hook.remove()
        self.losses = [float(x) for x in steps] + [float(loss)]
        self.w3 = {k: p.detach().clone() for k, p in net.named_parameters()}

    def _pieces(self):
        """(batch rows, real queries, key) of each `train_epoch` call:
        each epoch's riffle permutation in pieces of `piece_steps` rows."""
        P = int(self.mix["piece_steps"])
        rows = -(-self.E // self.B)
        root = draws.key_of(self.ctx.seed)
        epoch = 0
        while True:
            ekey = draws.fold_in(root, 1000 + epoch)
            perm = riffle_permutation(draws.fold_in(ekey, 0), rows, self.B,
                                      device=self.dev)
            for j, lo in enumerate(range(0, rows, P)):
                hi = min(rows, lo + P)
                real = min(self.E, hi * self.B) - lo * self.B
                yield perm[lo:hi], real, draws.fold_in(ekey, 1 + j)
            epoch += 1

    def step(self) -> None:
        rows, real, key = next(self.pieces)
        self.trainer.train_epoch(self.q_edges, self.labels, key, perm=rows)
        self.work += real
        self.ran.append(rows)

    def traced_window(self) -> Tuple[tr.Trace, List[torch.Tensor]]:
        steps = int(self.mix["traced_steps"])
        before = len(self.ran)
        done = 0

        def run():
            nonlocal done
            while done < steps:
                self.step()
                done += self.ran[-1].shape[0]

        out = {}
        self.with_join_span(lambda: out.setdefault(
            "t", tr.traced(run, self.dev)))
        return out["t"], self.ran[before:]

    def query_counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(O, H) of every training query."""
        own = torch.empty(self.E, dtype=torch.int64, device=self.dev)
        hits = torch.empty_like(own)
        s = self.sets
        rows = lambda ids: (s.nodes[ids], s.khi[ids], s.klo[ids],
                            s.sizes[ids])
        for lo in range(0, self.E, self.B):
            e = self.q_edges[:, lo:lo + self.B]
            own[lo:lo + self.B], hits[lo:lo + self.B] = work.slot_counts(
                rows(e[0]), rows(e[1]))
        return own, hits

    def readings(self, window_s: float, window_rows: List[torch.Tensor],
                 trace: tr.Trace, traced_rows: List[torch.Tensor]
                 ) -> Readings:
        own, hits = self.query_counts()
        ids = torch.cat([r.reshape(-1) for r in window_rows])
        ids = ids[ids < self.E]
        fwd = work.forward_flops(float(own[ids].sum()), float(hits[ids].sum()),
                                 float(ids.numel()), self.S + 1,
                                 int(self.cfg["hidden_dim"]),
                                 self.cfg["aggregator"])
        counts = []
        for r in traced_rows:
            for row in r.clamp(max=self.E - 1):
                counts.append((float(own[row].sum()), float(hits[row].sum()),
                               float(row.numel())))
        return Readings("train", self.cfg, window_s, 3 * fwd, trace,
                        len(counts), counts)

    def check(self) -> List[Check]:
        """The checked call's three steps against the reference's, and a
        sample of the sets they read against the reference sampler's."""
        real = self.check_ids < self.E
        ids = self.check_ids.clamp(max=self.E - 1)
        ends = torch.unique(self.q_edges[:, ids.reshape(-1)].reshape(-1))
        s = self.sets
        rows = (s.nodes[ends], s.khi[ends], s.klo[ends], s.sizes[ends])
        checks = [self.check_sets(s, ends, self.ctx.seed)]
        del self.trainer, self.sets, s
        free(self.dev)

        def rows_of(nodes):
            at = torch.searchsorted(ends, nodes.to(ends.dtype))
            return tuple(t[at] for t in rows)

        rate = float(self.cfg["dropout"])
        hidden = int(self.cfg["hidden_dim"])
        w = {k: v.clone() for k, v in self.weights.items()}
        opt = ref.Adam(w, float(self.cfg["lr"]),
                       float(self.cfg["grad_clip"]))
        ref_losses, g1 = [], None
        _, key = draws.split(self.check_key)     # the steps' dropout chain
        with ref.full_fp32():
            for i in range(CHECKED_STEPS):
                key, sub = draws.split(key)
                keep = ref.dropout_keep(sub, rate, (self.B, hidden),
                                        self.dev)
                wt = real[i].to(torch.float32)
                loss, g = ref.train_step(
                    rows_of, self.q_edges[:, ids[i]], self.labels[ids[i]],
                    wt, w, opt, self.cfg["aggregator"], self.M, self.S,
                    keep, rate)
                ref_losses.append(loss)
                if i == 0:
                    g1 = g
        weight = real.sum(dim=1).to(torch.float64).tolist()
        ref_losses.append(sum(a * b for a, b in zip(ref_losses, weight))
                          / max(sum(weight), 1.0))
        change = {k: w[k] - self.weights[k] for k in w}
        got_change = {k: self.w3[k] - self.weights[k] for k in w}
        if len(self.losses) != len(ref_losses):
            loss_gap = float("inf")      # a step's loss never came
        else:
            loss_gap = max(gap(a, b, abs(b))
                           for a, b in zip(self.losses, ref_losses))
        checks.append(Check("loss_gap", loss_gap,
                            self.limits.get("loss_gap", 0.0)))
        checks.append(Check("grad_gap", leaf_gap(self.g1, g1, g1),
                            self.limits.get("grad_gap", 0.0)))
        checks.append(Check("change_gap", leaf_gap(got_change, change, g1),
                            self.limits.get("change_gap", 0.0)))
        return checks

