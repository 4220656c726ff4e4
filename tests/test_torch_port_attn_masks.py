"""PyTorch port, the attention pool on masks that span several 32-slot
tiles.

The CUDA kernels (csrc/attn_pool.cu, csrc/attn_pool_bwd.cu) walk only
the tiles of a row that hold a valid slot, and pool only its valid
slots. That is exact because a masked slot's weight is exactly 0 in fp32
whenever its row has a valid slot. Here the plain forward and backward,
which the kernels are held to on the card, are held to the JAX package's
`fused_attn_pool` (Pallas interpret mode) on the masks the skip must
keep: holes spanning whole tiles, valid slots only in the last tile, a
single valid slot (slot 0, or a slot deep in the row); and the exact
zeros the skip relies on are checked on the same masks. A row with no
valid slot is outside JAX's contract (sets hold their root), so it is
held on the card only, against the plain version (chip_smoke.py).

Tolerances as tests/test_torch_port_attn.py states them: forward
rtol = atol = 1e-5; gradients rtol 1e-4, atol 1e-5; the gconst gradient
(0 in exact arithmetic) atol 1e-5 alone.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from surel_plus_tpu.ops.pallas.hidden_sum_kernel import (
    fused_attn_pool as jax_fused_attn_pool,
)
from surel_plus_tpu_torch.ops.kernels.attn_pool import (
    MAX_DYN_SMEM,
    TILE,
    attn_slots_plain,
    attn_softmax_plain,
    bwd_smem_bytes,
    fused_attn_pool_bwd_plain,
    fused_attn_pool_plain,
)
from surel_plus_tpu_torch.ops.kernels.hidden_sum import NEG, u_core_rows
from surel_plus_tpu_torch.ops.walk import enc_field_layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H = 4, 16


def _mask(kind, ell, rng):
    """[B, ell] masks, every row with a valid slot."""
    m = np.zeros((B, ell), bool)
    last = (ell - 1) // TILE * TILE
    if kind == "holes":     # tile 1 empty, tiles 0 and 2.. half full
        m[:] = rng.random((B, ell)) < 0.5
        m[:, TILE:2 * TILE] = False
        m[:, 0] = True
    elif kind == "tail":    # valid only in the last tile
        m[:, last:] = rng.random((B, ell - last)) < 0.5
        m[:, -1] = True
    elif kind == "single":  # slot 0; the last slot; a slot of tile 1
        m[0, 0] = m[1, -1] = m[2, TILE + 3] = True
        m[3, rng.integers(0, ell)] = True
    return m


CASES = {"holes-L65": ("holes", 65), "tail-L97": ("tail", 97),
         "single-L70": ("single", 70)}


def _case(name, seed=0):
    """Operands at Q=2, B=4, H=16 in the lo-only layout (M=10, S'=3): keys
    with every field used, the case's masks, u_ext, gv and a cotangent."""
    kind, ell = CASES[name]
    nw, ns = 10, 3
    shift, starts, _ = enc_field_layout(nw, ns)
    rng = np.random.default_rng(seed)

    def keys():
        k = np.zeros((2, B, ell), np.uint32)
        for j in range(1, ns + 1):
            k |= rng.integers(0, nw + 1, size=k.shape).astype(
                np.uint32) << np.uint32(starts[j])
        return k | rng.integers(0, 2, size=k.shape).astype(np.uint32)

    kown, kcross = keys(), keys()
    mask = np.stack([_mask(kind, ell, rng) for _ in range(2)])
    w1 = rng.normal(size=(ns + 1, H)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=H)).astype(np.float32)
    u = torch.cat([u_core_rows(torch.as_tensor(w1), nw, ns),
                   torch.full((1, H), NEG), torch.as_tensor(b1)[None]])
    return dict(kown=kown, kcross=kcross, mask=mask, u=u.numpy(),
                gvec=(0.3 * rng.normal(size=(H, 1))).astype(np.float32),
                gconst=np.array([[0.3]], np.float32),
                g=rng.normal(size=(2, B, H)).astype(np.float32),
                shift=int(nw).bit_length())


def _torch_args(c):
    t = lambda x: torch.as_tensor(np.array(x))
    gv = t(np.concatenate([c["gvec"], c["gconst"]]))
    return (t(c["kown"].view(np.int32)), t(c["kcross"].view(np.int32)),
            t(c["mask"]), t(c["u"]), gv, c["shift"])


def _jax_pool(c, u, gvec, gconst):
    return jax_fused_attn_pool(
        jnp.asarray(c["kown"]), jnp.asarray(c["kcross"]),
        jnp.asarray(c["mask"]), u, gvec, gconst, c["shift"],
        interpret=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pair_matches_jax_across_tiles(case):
    """The plain forward and its backward against JAX's kernel and
    `jax.grad` of it, on one case's masks."""
    c = _case(case)
    ju, jgv, jgc = (jnp.asarray(c[k]) for k in ("u", "gvec", "gconst"))
    want = np.asarray(_jax_pool(c, ju, jgv, jgc))
    want_u, want_gvec, want_gconst = jax.grad(
        lambda u, gvec, gconst: jnp.sum(_jax_pool(c, u, gvec, gconst)
                                        * jnp.asarray(c["g"])),
        argnums=(0, 1, 2))(ju, jgv, jgc)
    args = _torch_args(c)
    got, m, s = fused_attn_pool_plain(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    du, dgv = fused_attn_pool_bwd_plain(*args[:5], torch.as_tensor(c["g"]),
                                        m, s, args[5])
    np.testing.assert_allclose(du.numpy(), np.asarray(want_u), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dgv[:H].numpy(), np.asarray(want_gvec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dgv[H:].numpy(), np.asarray(want_gconst),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_slots_add_exact_zeros(case):
    """What lets the kernels skip masked slots and whole tiles without
    them: in a row with a valid slot, a masked slot's weight a and its
    dgate = a (da - t) are exactly 0, so its terms in s, the pool, dU,
    dgvec and dgconst are exact zeros; and the pool over the valid slots
    alone equals the plain pool."""
    c = _case(case, seed=1)
    args = _torch_args(c)
    *_, hs, gate = attn_slots_plain(*args)
    a, m, s = attn_softmax_plain(gate)
    masked = ~args[2]
    assert bool((a[masked] == 0).all())
    g = torch.as_tensor(c["g"])[:, :, None, :]
    da = (hs * g).sum(dim=-1)
    t = (a * da).sum(dim=-1, keepdim=True)
    assert bool(((a * (da - t))[masked] == 0).all())
    e = torch.where(args[2], torch.exp(gate - m[..., None]), 0.0)
    torch.testing.assert_close(e.sum(dim=-1), s, rtol=1e-6, atol=0)
    pooled = (e[..., None] * hs).sum(dim=-2) / s[..., None]
    torch.testing.assert_close(pooled, fused_attn_pool_plain(*args)[0],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ncol", [2, 4, 8])
def test_shared_memory_limit_did_not_fall(ncol):
    """Every (L, H) the wrappers took before the warp-per-row kernels
    (the 32-slot tile of H-wide hidden rows and two floats a slot in
    200 KiB) still fits one block's shared memory."""
    for h in (1, 32, 96, 256, 1024):
        threads = -(-h // 32) * 32
        longest = (200 * 1024 // 4 - TILE * threads) // 2
        for ell in (1, 301, 801, longest):
            assert bwd_smem_bytes(ell, h, ncol) <= MAX_DYN_SMEM, (ell, h)
