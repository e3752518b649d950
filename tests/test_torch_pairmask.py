"""The port's pair-mask tiles against the JAX package's Pallas kernel.

``repro.kernels.pairmask.pair_mask`` runs in interpret mode on the CPU,
as the JAX package's own tests run it.  Inputs come from seeded numpy
generators.  Every comparison is exact: the thresholds are set exactly
on accumulator values, where a different rounding order flips the mask.
"""
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hypdist import ops as jhyp
from repro.kernels.pairmask.pairmask import pair_mask as jpair_mask
from repro_torch.core import rhg as trhg
from repro_torch.kernels import build
from repro_torch.kernels.pairmask import ops as tops
from repro_torch.kernels.pairmask.ref import euclid_tile, hyp_tile, pair_mask_ref

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _points(rng, m, n, dim):
    """f32 point rows [m, 8] / [n, 8]: b is a jittered copy of a's first
    rows, so many pairs sit near any threshold."""
    a = np.zeros((m, 8), np.float32)
    b = np.zeros((n, 8), np.float32)
    a[:, :dim] = rng.random((m, dim))
    b[:, :dim] = a[:n, :dim] + rng.normal(0, 0.02, (n, dim))
    return a, b


def _fused_acc(a, b, dim):
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    d = [A[:, None, k] - B[None, :, k] for k in range(dim)]
    acc = torch.addcmul(d[1] * d[1], d[0], d[0])
    if dim == 3:
        acc = torch.addcmul(acc, d[2], d[2])
    return acc.numpy()


def _unfused_acc(a, b, dim):
    d = a[:, None, :dim] - b[None, :, :dim]
    acc = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    if dim == 3:
        acc = acc + d[..., 2] * d[..., 2]
    return acc


@pytest.mark.parametrize("dim", [2, 3])
def test_euclid_equals_pallas_with_thresholds_on_accumulators(dim):
    rng = np.random.default_rng(100 + dim)
    a, b = _points(rng, 256, 128, dim)
    fused, plain = _fused_acc(a, b, dim), _unfused_acc(a, b, dim)
    # pairs that the unfused order would put above a threshold set on
    # their fused accumulator
    split = np.argwhere(plain > fused)
    assert len(split), "no pair where the rounding order matters"
    for i, j in split[:: max(1, len(split) // 4)][:4]:
        r2 = float(fused[i, j])
        want = np.asarray(jpair_mask(jnp.asarray(a), jnp.asarray(b), r2, tile="euclid",
                                     dim=dim, interpret=True))
        got = pair_mask_ref(torch.from_numpy(a), torch.from_numpy(b), r2, tile="euclid",
                            dim=dim).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[i, j] == 1 and plain[i, j] > np.float32(r2)


def _hyp_rows(rng, m):
    r = rng.uniform(0.2, 12.0, m)
    theta = rng.uniform(0, 2 * math.pi, m)
    return jhyp.pad_features(jhyp.precompute_features(r, theta))


def test_hyp_equals_pallas_with_threshold_on_an_accumulator():
    rng = np.random.default_rng(7)
    q, c = _hyp_rows(rng, 256), _hyp_rows(rng, 128)
    Q, C = torch.from_numpy(q), torch.from_numpy(c)
    rest = torch.addcmul(torch.addcmul(Q[:, None, 1] * C[None, :, 1], Q[:, None, 0],
                                       C[None, :, 0]), -Q[:, None, 2], C[None, :, 2])
    p = Q[:, None, 3] * C[None, :, 3]
    for i, j in [(3, 5), (100, 17), (250, 127)]:
        cosh_r = float(-rest[i, j] / p[i, j])   # acc of (i, j) lands within ulps of 0
        want = np.asarray(jpair_mask(jnp.asarray(q), jnp.asarray(c), cosh_r, tile="hyp",
                                     interpret=True))
        got = pair_mask_ref(Q, C, cosh_r, tile="hyp").numpy()
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("tile,dim", [("euclid", 2), ("euclid", 3), ("hyp", 2)])
def test_batched_wrapper_on_cpu_equals_pallas_per_batch(tile, dim):
    rng = np.random.default_rng(11)
    if tile == "euclid":
        rows = [_points(rng, 128, 128, dim) for _ in range(3)]
        scalar = 0.0004
    else:
        rows = [(_hyp_rows(rng, 128), _hyp_rows(rng, 128)) for _ in range(3)]
        scalar = math.cosh(14.0)
    a = torch.from_numpy(np.stack([x for x, _ in rows]))
    b = torch.from_numpy(np.stack([y for _, y in rows]))
    before = build.LAUNCHES["pair_mask"]
    got = tops.pair_mask(a, b, scalar, tile=tile, dim=dim)
    assert build.LAUNCHES["pair_mask"] == before   # the CPU runs the plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == (3, 128, 128)
    for k, (x, y) in enumerate(rows):
        want = np.asarray(jpair_mask(jnp.asarray(x), jnp.asarray(y), scalar, tile=tile,
                                     dim=dim, interpret=True))
        np.testing.assert_array_equal(got[k].numpy(), want)
    np.testing.assert_array_equal(tops.pair_mask(a[0], b[0], scalar, tile=tile, dim=dim),
                                  got[0])


def test_tiles_broadcast_over_batches():
    rng = np.random.default_rng(3)
    a, b = _points(rng, 16, 16, 2)
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    r2 = torch.tensor([[[1e-3]], [[1e-2]]], dtype=torch.float32)
    both = euclid_tile(A.expand(2, 16, 8), B.expand(2, 16, 8), r2, 2)
    assert torch.equal(both[0], euclid_tile(A, B, 1e-3, 2))
    assert torch.equal(both[1], euclid_tile(A, B, 1e-2, 2))
    q = torch.from_numpy(_hyp_rows(rng, 16))
    assert torch.equal(hyp_tile(q[None], q[None], torch.tensor([[[50.0]]], dtype=torch.float64))[0],
                       hyp_tile(q, q, 50.0))


def test_unknown_tile_and_bad_dim_raise():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tops.pair_mask(a, a, 1.0, tile="cosine")
    with pytest.raises(ValueError):
        pair_mask_ref(a, a, 1.0, tile="euclid", dim=4)


def _exact_fma_f32(x, y, z):
    """fma(x, y, z) rounded once to float32 (nearest, ties to even)."""
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - exact) for c in cands]
    best = min(err)
    tied = [c for c, e in zip(cands, err) if e == best]
    return min(tied, key=lambda c: int(np.float32(c).view(np.uint32)) & 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_addcmul_is_a_single_rounded_fma(dtype):
    rng = np.random.default_rng(5)
    npd = np.float64 if dtype == torch.float64 else np.float32
    x, y, z = (rng.normal(size=4000).astype(npd) for _ in range(3))
    got = torch.addcmul(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(y)).numpy()
    if dtype == torch.float64:
        want = np.array([float(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                         for a, b, c in zip(x, y, z)])
    else:
        want = np.array([_exact_fma_f32(a, b, c) for a, b, c in zip(x, y, z)], np.float32)
    np.testing.assert_array_equal(got, want)
    # a plain multiply-then-add rounds twice and differs somewhere
    assert not np.array_equal(x * y + z, want)


@pytest.mark.parametrize("R", [0.0, 3.5, 40.0, 699.9, 700.0, 710.5, 1e4])
def test_cosh_threshold_matches_reference(R):
    assert trhg.cosh_threshold(R) == jhyp.cosh_threshold(R)
