"""Faults planted in the program under test, underneath the timed path:
each check must come out not correct with one in place. Used by the
benchmark's tests on the CPU and by `perfbench.control --fault` on the
card, where a training cell's faults give upper readings of its limits.

- "state unchanged": a training step leaves the parameters as they were;
- "half the batch": the loss is the mean over the first half of the batch;
- "answer altered": every logit is scaled by 1.001 where it is produced;
- "set altered": one bit of every set's first key is flipped.

No cell spans chips, so no fault leaves out an exchange between them.
"""

from __future__ import annotations

import contextlib

FAULTS = ("state unchanged", "half the batch", "answer altered",
          "set altered")


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault `name` in place, restored afterwards."""
    from surel_plus_tpu_torch.models.net import Net
    from surel_plus_tpu_torch.ops import walk
    from surel_plus_tpu_torch.train import device

    if name == "state unchanged":
        where, attr, new = device, "adam_step", lambda *a, **k: None
    elif name == "half the batch":
        loss = device.batch_loss

        def new(logits, labels, weights):
            w = weights.clone()
            w[w.shape[0] // 2:] = 0
            return loss(logits, labels, w)
        where, attr = device, "batch_loss"
    elif name == "answer altered":
        forward = Net.forward
        where, attr = Net, "forward"

        def new(self, *a, **k):
            return forward(self, *a, **k) * 1.001
    elif name == "set altered":
        build = walk.build_sets_packed_block
        where, attr = walk, "build_sets_packed_block"

        def new(*a, **k):
            nodes, sizes, hi, lo = build(*a, **k)
            lo = lo.clone()
            lo[:, 0] ^= 1
            return nodes, sizes, hi, lo
    else:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    old = getattr(where, attr)
    setattr(where, attr, new)
    try:
        yield
    finally:
        setattr(where, attr, old)
