"""The port's pair-mask tiles against the JAX package's Pallas kernel.

``repro.kernels.pairmask.pair_mask`` runs in interpret mode on the CPU,
as the JAX package's own tests run it.  Inputs come from seeded numpy
generators.  Every comparison is exact: the thresholds are set exactly
on accumulator values, where a different rounding order flips the mask.
``hyp_edges`` (the hyp test over ragged segments, hits compacted) is held
against the jitted ``hyp_mask_ref`` that the reference's ``rhg_pe`` runs
on the CPU, segment by segment.
"""
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hypdist import ops as jhyp
from repro.kernels.pairmask.pairmask import pair_mask as jpair_mask
from repro.kernels.pairmask.ref import hyp_mask_ref
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


_hyp_mask_jit = jax.jit(hyp_mask_ref)


def _feature_rows(rng, m, r_hi=12.0):
    """float64 feature rows ``[m, 8]`` (the reference's layout) of random
    points with radii in [0.2, r_hi)."""
    return jhyp.precompute_features(rng.uniform(0.2, r_hi, m), rng.uniform(0, 2 * math.pi, m))


def _hyp_edges_want(q8, c8, q_gid, c_gid, rows, cosh_r):
    """The reference's hits segment by segment: ``np.nonzero`` of the
    jitted ``hyp_mask_ref`` of each segment's rows, self-pairs dropped
    (the reference's ``emit``)."""
    out = [np.zeros((0, 2), np.int64)]
    for qo, ql, co, cl in rows:
        mask = np.asarray(_hyp_mask_jit(jnp.asarray(q8[qo:qo + ql]), jnp.asarray(c8[co:co + cl]),
                                        cosh_r))
        ii, jj = np.nonzero(mask)
        u, v = q_gid[qo + ii], c_gid[co + jj]
        out.append(np.stack([u[u != v], v[u != v]], axis=1))
    return np.concatenate(out)


def _hyp_edges_got(q8, c8, q_gid, c_gid, rows, cosh_r):
    got = tops.hyp_edges(torch.from_numpy(np.ascontiguousarray(q8[:, :4])),
                         torch.from_numpy(np.ascontiguousarray(c8[:, :4])),
                         torch.from_numpy(q_gid), torch.from_numpy(c_gid),
                         torch.tensor(rows, dtype=torch.int64).reshape(-1, 4), cosh_r)
    assert got.dtype == torch.int64 and got.shape[1:] == (2,)
    return got.numpy()


# ragged segment tables over q [300, .] and c [700, .]: (q_off, q_len,
# c_off, c_len) rows, the threshold R (cosh R is the tile's scalar)
HYP_TABLES = {
    "ragged": ([(0, 300, 0, 700), (17, 129, 5, 255), (299, 1, 0, 700), (3, 127, 600, 100)], 9.0),
    "empty-segments": ([(0, 0, 0, 700), (10, 50, 3, 0), (0, 0, 0, 0), (40, 1, 699, 1),
                        (300, 0, 700, 0), (100, 200, 0, 129)], 9.0),
    "q_len-1": ([(k, 1, 2 * k, 257) for k in range(0, 150, 37)], 11.0),
    "no-segment": ([], 9.0),
    # a core-like block: every pair within distance R, self-pairs dropped
    "every-pair-a-hit": ([(0, 100, 0, 130), (0, 300, 600, 100)], 60.0),
}


@pytest.mark.parametrize("name", list(HYP_TABLES))
def test_hyp_edges_equals_jitted_reference_per_segment(name):
    rows, R = HYP_TABLES[name]
    rng = np.random.default_rng(23)
    r_hi = 3.0 if name == "every-pair-a-hit" else 12.0
    q8, c8 = _feature_rows(rng, 300, r_hi), _feature_rows(rng, 700, r_hi)
    # gids with repeats across the sides, so some pairs are self-pairs
    q_gid = rng.integers(0, 400, 300).astype(np.int64)
    c_gid = rng.integers(0, 400, 700).astype(np.int64)
    cosh_r = math.cosh(R)
    want = _hyp_edges_want(q8, c8, q_gid, c_gid, rows, cosh_r)
    before = build.LAUNCHES["hyp_edges"]
    got = _hyp_edges_got(q8, c8, q_gid, c_gid, rows, cosh_r)
    assert build.LAUNCHES["hyp_edges"] == before   # the CPU runs the plain version
    np.testing.assert_array_equal(got, want)
    if name == "every-pair-a-hit":
        pairs = sum(ql * cl for _, ql, _, cl in rows)
        self_pairs = sum(int((q_gid[qo:qo + ql, None] == c_gid[None, co:co + cl]).sum())
                         for qo, ql, co, cl in rows)
        assert self_pairs > 0 and len(got) == pairs - self_pairs
    elif rows:
        assert 0 < len(got) < sum(ql * cl for _, ql, _, cl in rows)


def test_hyp_edges_equals_reference_with_threshold_on_an_accumulator():
    """cosh R set so that one pair's accumulator lands within ulps of 0,
    where the rounding order decides the test: the plain ``hyp_edges``
    keeps exactly the jitted reference's pairs (and the Pallas kernel's
    mask in interpret mode)."""
    rng = np.random.default_rng(7)
    q8, c8 = _feature_rows(rng, 200), _feature_rows(rng, 150)
    Q, C = torch.from_numpy(q8), torch.from_numpy(c8)
    rest = torch.addcmul(torch.addcmul(Q[:, None, 1] * C[None, :, 1], Q[:, None, 0],
                                       C[None, :, 0]), -Q[:, None, 2], C[None, :, 2])
    p = Q[:, None, 3] * C[None, :, 3]
    q_gid, c_gid = np.arange(200, dtype=np.int64), np.arange(1000, 1150, dtype=np.int64)
    rows = [(0, 200, 0, 150), (3, 90, 5, 130), (150, 50, 17, 1)]
    for i, j in [(3, 5), (100, 17), (199, 149), (160, 17)]:
        cosh_r = float(-rest[i, j] / p[i, j])
        want = _hyp_edges_want(q8, c8, q_gid, c_gid, rows, cosh_r)
        got = _hyp_edges_got(q8, c8, q_gid, c_gid, rows, cosh_r)
        np.testing.assert_array_equal(got, want)
        pallas = np.asarray(jpair_mask(jnp.asarray(jhyp.pad_features(q8, 256)),
                                       jnp.asarray(jhyp.pad_features(c8, 256)), cosh_r,
                                       tile="hyp", interpret=True))[:200, :150]
        ii, jj = np.nonzero(pallas)
        np.testing.assert_array_equal(got[:len(ii)], np.stack([q_gid[ii], c_gid[jj]], 1))
        assert 0 < len(ii) < 200 * 150


def _edges_inputs(Q=6, C=9, S=2):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(np.ascontiguousarray(_feature_rows(rng, Q)[:, :4]))
    c = torch.from_numpy(np.ascontiguousarray(_feature_rows(rng, C)[:, :4]))
    seg = torch.tensor([[0, Q, 0, C]] * S, dtype=torch.int64)
    return [q, c, torch.arange(Q), torch.arange(C), seg, 50.0]


BAD_TABLES = {"q_len past q": [0, 7, 0, 9], "q_off past q": [7, 0, 0, 0],
              "c_len past c": [0, 6, 4, 6], "negative q_off": [-1, 1, 0, 9],
              "negative c_len": [0, 6, 0, -1]}


@pytest.mark.parametrize("what", list(BAD_TABLES))
def test_hyp_edges_raises_on_a_table_out_of_range(what):
    args = _edges_inputs()
    args[4][1] = torch.tensor(BAD_TABLES[what])
    with pytest.raises(ValueError, match="segment 1 .* out of range"):
        tops.hyp_edges(*args)


BAD_ARGS = {"float32 q": (0, lambda t: t.float()), "int32 gids": (2, lambda t: t.int()),
            "float64 table": (4, lambda t: t.double()), "q of 8 columns": (
                0, lambda t: torch.cat([t, t], 1)), "table of 3 columns": (4, lambda t: t[:, :3]),
            "c_gid too short": (3, lambda t: t[:-1]),
            "strided c": (1, lambda t: torch.cat([t, t], 1)[:, ::2])}


@pytest.mark.parametrize("what", list(BAD_ARGS))
def test_hyp_edges_raises_on_a_wrong_argument(what):
    args = _edges_inputs()
    k, change = BAD_ARGS[what]
    args[k] = change(args[k])
    with pytest.raises(ValueError):
        tops.hyp_edges(*args)
