"""train_mfu: the training window's model FLOPs (perfbench/work.py:
forward_flops, the backward twice the forward) over the window's seconds
and the H100's dense TF32 peak, in percent."""

from perfbench import work


def read(r):
    if r.kind != "train" or not r.flops:
        return None
    return 100.0 * r.flops / (r.window_s * work.TF32_FLOPS)
