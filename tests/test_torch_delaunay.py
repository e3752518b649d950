"""The port's Delaunay kernels' plain versions against the JAX package.

* ``circumsphere`` against ``repro.kernels.delaunay.circumsphere`` (the
  jitted predicate of the planning pass) and ``circumsphere_in_box``
  against the engine's GEOM_CERT certificate, bit for bit, with the box
  set exactly on the computed circumsphere and one ulp to either side;
* ``triangulate_ref`` against ``delaunay_ref`` (the reference's CPU
  path) on ``ok`` for every row and on ``simp`` and ``alive`` for every
  ``ok`` row: random rows, padded rows, a cocircular square, collinear,
  coplanar and lattice inputs, duplicated points, and rows whose last
  point lies exactly on a triangle's circumcircle under the slot scan's
  arithmetic (an exact ``d2 == rr`` tie, which must clear ``ok`` where
  the reference clears it);
* ``triangulate_ref`` against the Pallas ``delaunay_call`` in interpret
  mode on one tiny shape, and the capacities.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rdg as jrdg
from repro.distrib import engine as jeng
from repro.kernels.delaunay import circumsphere as jax_circumsphere
from repro.kernels.delaunay import ops as jops
from repro.kernels.delaunay.delaunay import delaunay_call
from repro.kernels.delaunay.ref import delaunay_ref
from repro_torch.core import rdg as trdg
from repro_torch.kernels.delaunay import ops as tops
from repro_torch.kernels.delaunay.predicates import (circumsphere, circumsphere_in_box,
                                                     sqrt_rn)
from repro_torch.kernels.delaunay.ref import triangulate_ref
from torch_dt_rows import overflow_row
from torch_dt_rows import tie_rows as _tie_rows

torch.set_num_threads(1)


def _simplices(seed, k, dim):
    """Random simplices, with degenerate ones mixed in: a repeated vertex,
    collinear / coplanar vertices, and a dyadic lattice simplex."""
    rng = np.random.default_rng(seed)
    s = rng.random((k, dim + 1, dim))
    s[0, 1] = s[0, 0]
    s[1] = np.linspace(0.25, 0.75, dim + 1)[:, None]      # collinear, exactly
    s[2] = np.round(s[2] * 8) / 8
    if dim == 3:
        s[3, :, 2] = 0.5                                  # coplanar, exactly
    return s


@pytest.mark.parametrize("dim", [2, 3])
def test_circumsphere_matches_reference(dim):
    s = _simplices(10 + dim, 1 << 14, dim)
    want = [np.asarray(x) for x in jax.jit(jax_circumsphere)(jnp.asarray(s))]
    got = [x.numpy() for x in circumsphere(torch.from_numpy(s))]
    assert not want[2][:2].any() and want[2][4:].all() and (dim == 2 or not want[2][3])
    for g, w, name in zip(got, want, ("center", "r2", "nondeg")):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("dim", [2, 3])
def test_host_circumspheres_match_reference(dim):
    s = _simplices(20 + dim, 3000, dim)
    for got, want in zip(trdg.circumspheres(s, device="cpu"), jrdg.circumspheres(s)):
        np.testing.assert_array_equal(got, want)


def _boxes_on_the_sphere(s, seed):
    """Boxes ``[lo, hi]`` set exactly on each simplex's computed
    circumsphere, then one ulp in or out per coordinate at random."""
    c, r2, _ = circumsphere(torch.from_numpy(s))
    rad = sqrt_rn(r2).numpy()[:, None]
    box = np.concatenate([c.numpy() - rad, c.numpy() + rad], axis=1)
    mode = np.random.default_rng(seed).integers(0, 3, box.shape)
    return np.where(mode == 1, np.nextafter(box, np.inf),
                    np.where(mode == 2, np.nextafter(box, -np.inf), box))


@pytest.mark.parametrize("dim", [2, 3])
def test_certificate_matches_engine_on_the_box_boundary(dim):
    s = _simplices(30 + dim, 1 << 13, dim)
    box = _boxes_on_the_sphere(s, dim)
    G = (dim + 1) * dim
    geom_a = s.reshape(len(s), G)
    geom_b = np.ones((len(s), G))
    geom_b[:, :2 * dim] = box
    want = np.asarray(jax.jit(jax.vmap(lambda a, b: jeng._circumsphere_in_box(a, b, dim)))(
        jnp.asarray(geom_a), jnp.asarray(geom_b)))
    got = circumsphere_in_box(torch.from_numpy(s), torch.from_numpy(box[:, :dim]),
                              torch.from_numpy(box[:, dim:])).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95                   # both outcomes occur


def test_sqrt_is_correctly_rounded():
    """PyTorch's vectorised CPU sqrt misses the correctly rounded value on
    some inputs; the certificate's radius must be numpy's (XLA's
    ``vsqrtpd``, CUDA's double ``sqrt``)."""
    x = np.random.default_rng(5).random(1 << 16)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


def _compare(pts, cnt, dim):
    """The plain triangulation against the reference's: ``ok`` on every
    row, ``simp`` and ``alive`` on every ``ok`` row."""
    pts = np.asarray(pts, np.float64)
    cnt = np.asarray(cnt, np.int64)
    N = pts.shape[1]
    kw = dict(dim=dim, num_simplices=tops.simplex_capacity(N, dim),
              cavity=tops.cavity_capacity(dim), group=tops.group_size(dim))
    js, ja, jo = (np.asarray(x) for x in delaunay_ref(jnp.asarray(pts),
                                                      jnp.asarray(cnt, jnp.int32), **kw))
    ts, ta, to = (x.numpy() for x in triangulate_ref(torch.from_numpy(pts),
                                                     torch.from_numpy(cnt), **kw))
    np.testing.assert_array_equal(to, jo.astype(bool))
    np.testing.assert_array_equal(ts[to], js[to])
    np.testing.assert_array_equal(ta[to], ja[to].astype(bool))
    assert ts.dtype == np.int32 and ta.dtype == bool
    return to


@pytest.mark.parametrize("dim,N", [(2, 96), (2, 384), (3, 64), (3, 160)])
def test_triangulate_matches_reference_on_random_rows(dim, N):
    rng = np.random.default_rng(dim * 1000 + N)
    cnt = rng.integers(dim + 2, N + 1, 6)
    cnt[[1, 4]] = [0, N]
    pts = rng.random((6, N, dim))
    for i, c in enumerate(cnt):
        pts[i, c:] = 0.0
    ok = _compare(pts, cnt, dim)
    assert ok.all()


def _padded(rows, N):
    """Point sets of different sizes as one padded batch and its counts."""
    pts = np.zeros((len(rows), N, rows[0].shape[1]))
    for i, r in enumerate(rows):
        pts[i, :len(r)] = r
    return pts, [len(r) for r in rows]


def test_triangulate_matches_reference_on_degenerate_rows():
    rng = np.random.default_rng(9)
    sq = np.array([[0.2, 0.2], [0.8, 0.2], [0.8, 0.8], [0.2, 0.8]])       # cocircular
    line = np.stack([np.linspace(0.1, 0.9, 5), np.full(5, 0.5)], axis=1)    # collinear
    lattice = np.stack(np.meshgrid(np.arange(6) / 6, np.arange(6) / 6), -1).reshape(-1, 2)
    dup = rng.random((200, 2))
    dup[100:110] = dup[:10]                                                # repeated points
    ok = _compare(*_padded([sq, line, lattice, dup, dup[:150], dup[:3]], 200), 2)
    assert not ok[:3].any()
    flat = rng.random((8, 3))
    flat[:, 2] = 0.5                                                       # coplanar
    cube = np.round(rng.random((120, 3)) * 6) / 6
    ok = _compare(*_padded([flat, cube, cube[:60]], 120), 3)
    assert not ok[1:].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_exact_insphere_ties_clear_ok_where_the_reference_does(dim):
    pts = _tie_rows(dim, 24, 40 + dim)
    ok = _compare(pts, np.full(len(pts), dim + 2), dim)
    assert (~ok).sum() >= 12                    # the ties are seen
    # the same rows with the last point moved off the sphere triangulate
    off = pts.copy()
    c = off[:, :dim + 1].mean(axis=1)
    off[:, -1] += 1e-6 * (off[:, -1] - c)
    assert _compare(off, np.full(len(pts), dim + 2), dim).sum() >= 12


@pytest.mark.parametrize("dim", [2, 3])
def test_cavity_overflow_clears_ok_where_the_reference_does(dim):
    """The centre of a near-spherical ring, inserted last, has a cavity
    past the capacity; the ring alone triangulates."""
    rows = [overflow_row(dim, 50 + dim + s) for s in range(2)]
    ok = _compare(*_padded(rows + [r[:-1] for r in rows], len(rows[0])), dim)
    assert ok.tolist() == [False, False, True, True]


def test_trip_parts_are_card_only():
    pts, cnt = torch.rand((1, 8, 2), dtype=torch.float64), torch.tensor([8])
    with pytest.raises(ValueError, match="CUDA"):
        tops.triangulate(pts, cnt, dim=2, num_simplices=tops.simplex_capacity(8, 2),
                         cavity=32, group=4, parts=torch.zeros((1, 6), dtype=torch.int64))


def test_triangulate_matches_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(3)
    pts = rng.random((2, 16, 2))
    cnt = np.array([16, 9])
    S = jops.simplex_capacity(16, 2)
    js, ja, jo = (np.asarray(x) for x in delaunay_call(
        jnp.asarray(pts), jnp.asarray(cnt, jnp.int32), dim=2, num_simplices=S,
        cavity=jops.cavity_capacity(2), group=jops.group_size(2), interpret=True))
    ts, ta, to = (x.numpy() for x in triangulate_ref(
        torch.from_numpy(pts), torch.from_numpy(cnt), dim=2, num_simplices=S,
        cavity=tops.cavity_capacity(2), group=tops.group_size(2)))
    assert to.all() and jo.all()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ta, ja.astype(bool))


@pytest.mark.parametrize("dim", [2, 3])
def test_capacities_match_reference(dim):
    for n in (1, 128, 69632):
        assert tops.simplex_capacity(n, dim) == jops.simplex_capacity(n, dim)
    assert tops.cavity_capacity(dim) == jops.cavity_capacity(dim)
    assert tops.group_size(dim) == jops.group_size(dim)


def test_batched_delaunay_on_cpu_and_work_counts():
    rng = np.random.default_rng(8)
    pts = rng.random((3, 64, 2))
    simp, alive, ok = tops.batched_delaunay(pts, [64, 0, 30], dim=2, device="cpu")
    assert ok.all() and simp.shape == (3, tops.simplex_capacity(64, 2), 3)
    assert int(alive[1].sum()) == 1                     # a count-0 row: the super-simplex
    work = torch.zeros((3, 2), dtype=torch.int64)
    again = tops.triangulate(torch.from_numpy(pts), torch.tensor([64, 0, 30]), dim=2,
                             num_simplices=simp.shape[1], cavity=tops.cavity_capacity(2),
                             group=tops.group_size(2), work=work)
    assert all(torch.equal(a, b) for a, b in zip(again, (simp, alive, ok)))
    # a trip accepts 1..G points; its scan sees at least the super-simplex
    assert work[1].tolist() == [0, 0] and (work[[0, 2], 0] >= torch.tensor([16, 8])).all()
    assert (work[[0, 2], 1] >= work[[0, 2], 0]).all()
    with pytest.raises(ValueError, match="dimensional"):
        tops.batched_delaunay(pts, [64, 0, 30], dim=3, device="cpu")
