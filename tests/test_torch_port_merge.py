"""PyTorch port, the join's merge: the plain version of the merge kernel
held to the JAX merge network (merge_pairs_xor) and to the Pallas merge
kernel in interpret mode, bit for bit; the kernel itself is held to the
plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.merge_net import merge_pairs_xor
from surel_plus_tpu.ops.pallas.bitonic_merge import bitonic_merge_pairs
from surel_plus_tpu_torch.ops.kernels.merge import merge_pairs_cuda
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
