"""Sampling traffic: closed-loop passes of `sample_gsets_device_keys`
over every node, blocks of `set_block` seeds, a fresh walk key a pass;
the previous pass's store is dropped as the next one lands, so at most
one old store is live. The check: a sample of the last pass's sets
against the reference sampler's, word for word.
"""

from __future__ import annotations

from typing import List

import torch

from perfbench import drive
from perfbench import trace as tr
from perfbench.drive import Check, Readings
from surel_plus_tpu_torch.ops.sampler import sample_gsets_device_keys


class Cell(drive.Cell):

    def setup(self) -> None:
        self.sample_sets(self.edges())
        self.pass_seed = self.ctx.seed
        self.store = self._pass()       # warms every block shape

    @staticmethod
    def control_config(config: dict) -> dict:
        return dict(config)

    def control(self) -> None:
        """The sampler states no precision: the control breaks the guarantee
        that a pass's sets are its key's, checking the last pass against
        its neighbouring key."""
        self.pass_seed -= 1

    def _pass(self):
        self.pass_seed += 1
        self.store = None               # at most one old store is live
        return sample_gsets_device_keys(
            self.graph, self.all_seeds, self.M, self.S, seed=self.pass_seed,
            block_size=self.block, shuffle_seed=self.ctx.seed,
            device=self.dev)

    def step(self) -> None:
        self.store = self._pass()
        self.ran.append(self.pass_seed)
        self.work += self.n

    def words_a_pass(self) -> float:
        """The sampler's threefry words a pass: S' - 1 steps of M words for
        every seed."""
        return float(max(self.S - 1, 0) * self.M * self.n)

    def traced_window(self):
        before = len(self.ran)

        def run():
            for _ in range(int(self.mix["traced_passes"])):
                self.step()

        return tr.traced(run, self.dev), self.ran[before:]

    def readings(self, window_s, window_ran, trace, traced_ran
                 ) -> Readings:
        return Readings("sample", self.cfg, window_s, None, trace,
                        len(traced_ran), [],
                        words=len(traced_ran) * self.words_a_pass())

    def check(self) -> List[Check]:
        rows = torch.arange(self.n, device=self.dev)
        return [self.check_sets(self.store, rows, self.pass_seed)]
