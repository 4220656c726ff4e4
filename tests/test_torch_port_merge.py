"""PyTorch port, the join's merge: the plain version of the merge kernel
held to the JAX merge network (merge_pairs_xor) and to the Pallas merge
kernel in interpret mode, bit for bit, and so is the kernel's merge path
(`merge_path_corank`, `merge_pairs_path`: its co-rank splits and
sequential runs, emulated); the kernel itself is held to the plain
version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.merge_net import merge_pairs_xor
from surel_plus_tpu.ops.pallas.bitonic_merge import bitonic_merge_pairs
from surel_plus_tpu_torch.ops.kernels.merge import (
    BLOCK_ROW_THREADS,
    WARP_ROW_THREADS,
    merge_pairs_cuda,
    merge_pairs_path,
    merge_pairs_plain,
    merge_path_corank,
)
from surel_plus_tpu_torch.ops.merge_net import merge_pairs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _distinct_case(rng, B, la, lb):
    """Distinct keys via the tag bit, like the join's packed keys."""
    ka = np.sort(rng.integers(0, 1 << 31, size=(B, la)).astype(np.uint32)
                 * 2, axis=1)
    kb = np.sort((rng.integers(0, 1 << 31, size=(B, lb)).astype(np.uint32)
                  * 2) | 1, axis=1)
    pa = rng.integers(0, 1 << 32, size=(B, la), dtype=np.int64).astype(
        np.uint32)
    pb = rng.integers(0, 1 << 32, size=(B, lb), dtype=np.int64).astype(
        np.uint32)
    return ka, pa, kb, pb


def _padded_case(rng, B, L):
    """Join-shaped rows: node << 1 | tag over unique ascending nodes,
    padded with INT32_MAX << 1 | tag (0xFFFFFFFE / 0xFFFFFFFF) and
    payload 0, sharing some nodes between the sides."""
    def side(tag):
        sizes = rng.integers(1, L + 1, size=B)
        keys = np.full((B, L), (0x7FFFFFFF << 1) | tag, np.uint32)
        pays = np.zeros((B, L), np.uint32)
        for b, n in enumerate(sizes):
            nodes = np.sort(rng.choice(3 * L, size=n, replace=False))
            keys[b, :n] = (nodes.astype(np.uint32) << 1) | tag
            pays[b, :n] = rng.integers(1, 1 << 32, size=n, dtype=np.int64)
        return keys, pays

    kv, pv = side(0)
    ku, pu = side(1)
    return kv, pv, ku, pu


def _port(ka, pa, kb, pb):
    t = lambda x: torch.as_tensor(x.view(np.int32))
    k, p = merge_pairs(t(ka), t(pa), t(kb), t(pb))
    return k.numpy().view(np.uint32), p.numpy().view(np.uint32)


def _check(ka, pa, kb, pb):
    got_k, got_p = _port(ka, pa, kb, pb)
    args = [jnp.asarray(x) for x in (ka, pa, kb, pb)]
    for want_k, want_p in (merge_pairs_xor(*args),
                           bitonic_merge_pairs(*args, interpret=True)):
        np.testing.assert_array_equal(got_k, np.asarray(want_k))
        np.testing.assert_array_equal(got_p, np.asarray(want_p))


@pytest.mark.parametrize("B,la,lb", [(7, 13, 13), (4, 301, 301),
                                     (3, 37, 5), (5, 1, 9)])
def test_merge_matches_jax_distinct_keys(B, la, lb):
    _check(*_distinct_case(np.random.default_rng(la * 31 + lb), B, la, lb))


@pytest.mark.parametrize("B,L", [(6, 11), (4, 64)])
def test_merge_matches_jax_padded_rows(B, L):
    """Equal pad keys tie; their payloads are all 0, so any correct merge
    gives the same output, and unsigned order puts 0xFFFFFFFE first."""
    _check(*_padded_case(np.random.default_rng(B * L), B, L))


def test_merge_wrappers_reject_other_devices():
    """The kernel wrapper takes CUDA tensors only, and the dispatcher has
    no route for a device that is neither CUDA nor the CPU."""
    k = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        merge_pairs_cuda(k, k, k, k)
    m = k.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        merge_pairs(m, m, m, m)


def _tied_case(rng, B, la, lb, top):
    """Keys drawn from [0, top): many equal keys within and across the
    rows (top 1: every key equal), distinct payloads."""
    ka = np.sort(rng.integers(0, top, size=(B, la)), axis=1).astype(
        np.uint32)
    kb = np.sort(rng.integers(0, top, size=(B, lb)), axis=1).astype(
        np.uint32)
    pa = np.arange(B * la, dtype=np.uint32).reshape(B, la)
    pb = (np.arange(B * lb, dtype=np.uint32) + (1 << 31)).reshape(B, lb)
    return ka, pa, kb, pb


def _by_key_then_payload(keys, pay):
    """Payloads sorted within each run of equal keys (rows ascending)."""
    order = np.lexsort((pay, keys), axis=1)
    return np.take_along_axis(pay, order, axis=1)


@pytest.mark.parametrize("threads", [WARP_ROW_THREADS, BLOCK_ROW_THREADS])
@pytest.mark.parametrize("B,la,lb,top", [
    (5, 301, 301, 7),        # ties across a and b
    (4, 37, 5, 1),           # every key equal
    (6, 1, 9, 3),            # la = 1
    (3, 13, 1, 1 << 32),     # lb = 1, odd widths
    (3, 129, 67, 1 << 32)])  # odd widths, runs longer than a row's share
def test_merge_path_matches_plain_and_jax(B, la, lb, top, threads):
    """The kernel's partition and runs, emulated for a warp's and a
    block's threads, equal the plain merge and JAX's stable sort of the
    concatenation exactly; JAX's merge networks give the same keys and,
    within each run of equal keys (whose order they leave open), the same
    payloads."""
    ka, pa, kb, pb = _tied_case(np.random.default_rng(la * 7 + lb), B, la,
                                lb, top)
    t = lambda x: torch.as_tensor(x.view(np.int32))
    got = merge_pairs_path(t(ka), t(pa), t(kb), t(pb), threads)
    want = merge_pairs_plain(t(ka), t(pa), t(kb), t(pb))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gk, gp = got[0].numpy().view(np.uint32), got[1].numpy().view(np.uint32)
    cat = lambda x, y: jnp.concatenate([jnp.asarray(x), jnp.asarray(y)], 1)
    sk, sp = jax.lax.sort((cat(ka, kb), cat(pa, pb)), num_keys=1,
                          is_stable=True)
    np.testing.assert_array_equal(gk, np.asarray(sk))
    np.testing.assert_array_equal(gp, np.asarray(sp))
    args = [jnp.asarray(x) for x in (ka, pa, kb, pb)]
    for want_k, want_p in (merge_pairs_xor(*args),
                           bitonic_merge_pairs(*args, interpret=True)):
        np.testing.assert_array_equal(gk, np.asarray(want_k))
        np.testing.assert_array_equal(
            _by_key_then_payload(gk, gp),
            _by_key_then_payload(gk, np.asarray(want_p)))


def test_corank_on_ties():
    """On rows where every key is equal, the first d outputs take all of
    a's that fit (a before b on ties); the co-rank of every split counts
    exactly the a entries among the plain merge's first d outputs."""
    rng = np.random.default_rng(2)
    t = lambda x: torch.as_tensor(x.astype(np.uint32).view(np.int32))
    la, lb = 5, 7
    ka, kb = t(np.full((1, la), 9)), t(np.full((1, lb), 9))
    d = torch.arange(la + lb + 1)[None]
    assert merge_path_corank(ka, kb, d).tolist() == [
        [min(x, la) for x in range(la + lb + 1)]]
    ka, pa, kb, pb = _tied_case(rng, 4, 23, 17, 5)
    _, pay = merge_pairs_plain(t(ka), t(pa), t(kb), t(pb))
    from_a = (pay.numpy().view(np.uint32) < (1 << 31)).astype(np.int64)
    want = np.concatenate([np.zeros((4, 1), np.int64),
                           np.cumsum(from_a, axis=1)], axis=1)
    d = torch.arange(23 + 17 + 1).expand(4, -1)
    assert merge_path_corank(t(ka), t(kb), d).numpy().tolist() == \
        want.tolist()
