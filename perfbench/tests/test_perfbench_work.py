"""The yardstick's arithmetic against hand counts at a toy shape."""

import pytest
import torch

from perfbench import work
from perfbench.reference.sampler import INT32_MAX


def rows(nodes, keys):
    n = torch.tensor(nodes, dtype=torch.int32)
    lo = torch.tensor(keys, dtype=torch.int32)
    sizes = (n != INT32_MAX).sum(dim=1).to(torch.int32)
    return n, torch.zeros_like(lo), lo, sizes


def test_slot_counts_by_hand():
    P = INT32_MAX
    u = rows([[1, 3, 5, P], [2, 4, P, P]], [[9, 8, 7, 0], [6, 5, 0, 0]])
    v = rows([[3, 5, 6, 7], [1, P, P, P]], [[4, 3, 2, 1], [1, 0, 0, 0]])
    own, hits = work.slot_counts(u, v)
    # query 0: |S_u| 3 + |S_v| 4, common {3, 5} twice; query 1: 2 + 1, none
    assert own.tolist() == [7, 3]
    assert hits.tolist() == [4, 0]


def test_forward_flops_by_hand():
    h, ncol = 2, 3
    # one query, O = 5 valid slots, H = 2 hits
    first = (5 + 2) * 2 * (ncol + 1) * h            # 112
    sums = 2 * 5 * h                                # 20
    per_set = 2 * h * h + h                         # 10
    scorer = 2 * (2 * h) * h + h + 2 * h + 1        # 23
    mean = first + sums + 2 * per_set + scorer
    assert work.forward_flops(5, 2, 1, ncol, h, "mean") == mean
    attn = mean + 5 * 4 * h + 2 * per_set
    assert work.forward_flops(5, 2, 1, ncol, h, "attn") == attn


def test_least_ms_picks_the_larger():
    ms, by = work.least_ms(3.35e12, tc_flops=0.0)
    assert by == "bytes" and ms == pytest.approx(1e3)
    ms, by = work.least_ms(0.0, fp32_ops=67e12 * 2)
    assert by == "cuda cores" and ms == pytest.approx(2e3)
    ms, by = work.least_ms(1.0, tc_flops=495e12 * 3)
    assert by == "tensor cores" and ms == pytest.approx(3e3)


def test_kernel_bounds_by_hand():
    own, hits, q, ncol, h = 1000, 200, 10, 4, 96
    tc = (own + hits) * 2 * (ncol + 1) * h
    cuda = (own + hits) * h + 2 * own * h
    nbytes = own * 10 + 2 * q * h * 4 + (ncol + 2) * h * 4
    want = max(nbytes / 3.35e12, tc / 495e12, cuda / 67e12) * 1e3
    assert work.hidden_sum_ms(own, hits, q, ncol, h, False) == \
        pytest.approx(want)
    # K3: the same z products on the tensor cores as K1's
    cuda = (own + hits) * h + own * (h * 5 + 2)
    nbytes = own * 9 + 2 * q * (h + 2) * 4 + (ncol + 2) * h * 4
    want = max(nbytes / 3.35e12, tc / 495e12, cuda / 67e12) * 1e3
    assert work.attn_pool_ms(own, hits, q, ncol, h, False) == \
        pytest.approx(want)
    cuda = (own + hits) * h + own * (h * 10 + 8)
    want = max(nbytes / 3.35e12, tc / 495e12, cuda / 67e12) * 1e3
    assert work.attn_pool_ms(own, hits, q, ncol, h, True) == \
        pytest.approx(want)
    words = 1e6
    want = max(8 * words / 3.35e12, 75 * words / 33.5e12) * 1e3
    assert work.threefry_ms(words) == pytest.approx(want)


def test_rank_band_by_hand():
    from perfbench.kinds.rank import rank_band

    pos = torch.tensor([0.5, 0.3], dtype=torch.float64)
    neg = torch.tensor([[0.6, 0.5 + 1e-5, 0.4],
                        [0.1, 0.2, 0.3 - 1e-5]], dtype=torch.float64)
    # the reference's ranks: 3 (two negatives at or above), then 1
    low, high = rank_band(pos, neg, 0.0)
    assert low.tolist() == [3, 1] and high.tolist() == [3, 1]
    # within 1e-5 of each score the near ties may fall either way
    low, high = rank_band(pos, neg, 1e-5)
    assert low.tolist() == [2, 1] and high.tolist() == [3, 2]
