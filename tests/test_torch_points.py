"""Vertex positions in the port against the JAX package: counter
uniforms, PointPlan tables, the cell program, ``iter_points`` and
``generate(..., return_points=True)``.

Every position is compared bit for bit: RGG's cube points are exact IEEE
operations, and RHG's radius ``arccosh`` of a fused multiply-add goes
through the same ``log1p``/``log`` as the reference's compiled program
(``repro_torch.kernels.geom.libm``); its angle ``(cell + u) w`` is exact.
The port's cell program writes 0 into padding slots, where the reference
leaves its draws, so the cell program is compared on the masked slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import prng as jprng
from repro.distrib import runtime as jrt
from repro_torch import api as tapi
from repro_torch.core import prng as tprng
from repro_torch.distrib import runtime as trt
from repro_torch.kernels.geom.ref import cell_points_ref
from torch_geom_rows import cell_rows

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

SPECS = {
    "rgg2": ("RGG", dict(n=3000, radius=0.04, seed=51)),
    "rgg3": ("RGG", dict(n=2500, radius=0.09, dim=3, seed=52)),
    "rhg": ("RHG", dict(n=4000, avg_deg=12, gamma=2.7, seed=53)),
}
POINT_FIELDS = ("key_data", "count", "cell", "geom")


def specs(name):
    fam, kw = SPECS[name]
    return getattr(japi, fam)(**kw), getattr(tapi, fam)(**kw)


@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("capacity", [1, 24, 130])
def test_counter_uniform_matches_reference(capacity, width):
    rng = np.random.default_rng(capacity * 7 + width)
    words = rng.integers(0, 2 ** 32, (5, 2), dtype=np.uint64).astype(np.uint32)
    got = tprng.counter_uniform(torch.from_numpy(words.astype(np.int64)), capacity, width)
    assert got.dtype == torch.float64 and tuple(got.shape) == (5, capacity, width)
    for k, w in enumerate(words):
        want = np.asarray(jprng.counter_uniform(
            jax.random.wrap_key_data(jnp.asarray(w)), capacity, width))
        np.testing.assert_array_equal(got[k].numpy(), want)
        np.testing.assert_array_equal(tprng.counter_uniform(w, capacity, width).numpy(), want)


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_point_plan_tables_match_reference(name, P):
    jspec, tspec = specs(name)
    ref, got = jspec.point_plan(P), tspec.point_plan(P)
    for f in POINT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
    assert (got.kind, got.scale, got.dim, got.capacity, got.rng_impl) == (
        ref.kind, ref.scale, ref.dim, ref.capacity, ref.rng_impl)
    assert int(got.count.sum()) == tspec.n
    np.testing.assert_array_equal(got.stream_index(), ref.stream_index())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cell_program_matches_reference(name):
    jspec, tspec = specs(name)
    pts, mask, _ = jrt.run(jspec.point_plan(2))
    pts, mask = np.asarray(pts), np.asarray(mask)
    tpts, tmask = trt.run(tspec.point_plan(2), "cpu")
    assert tpts.dtype == torch.float64 and tuple(tpts.shape) == pts.shape
    np.testing.assert_array_equal(tmask.numpy(), mask)
    np.testing.assert_array_equal(tpts.numpy()[mask], pts[mask])
    assert not tpts.numpy()[~mask].any()                    # padding slots hold 0


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_iter_points_matches_reference(name, batch):
    jspec, tspec = specs(name)
    P = 3
    want: dict = {}
    for ch in japi.iter_points(jspec, P, batch=8):
        want.setdefault(ch.pe, []).append(ch.points())
    got: dict = {}
    for ch in tapi.iter_points(tspec, P, device="cpu", batch=batch):
        assert ch.buffer.ndim == (2 if batch == 1 else 3)
        got.setdefault(ch.pe, []).append(ch.points())
    assert sorted(got) == sorted(want)
    for pe in want:
        np.testing.assert_array_equal(torch.cat(got[pe]).numpy(), np.concatenate(want[pe]))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_return_points_matches_reference(name):
    jspec, tspec = specs(name)
    want = japi.generate(jspec, 2, return_points=True)
    got = tapi.generate(tspec, 2, device="cpu", return_points=True)
    assert got.points.dtype == torch.float64 and tuple(got.points.shape) == want.points.shape
    np.testing.assert_array_equal(got.points.numpy(), want.points)
    np.testing.assert_array_equal(got.edges.numpy(), want.edges)


def test_iter_points_refuses_families_without_points():
    with pytest.raises(TypeError, match="positions"):
        next(tapi.iter_points(tapi.GNM(n=100, m=200, seed=1), 1, device="cpu"))
    g = tapi.generate(tapi.GNM(n=100, m=200, seed=1), 1, device="cpu", return_points=True)
    assert g.points is None


def test_point_plan_reseed_equals_a_cold_plan():
    for name in ("rgg2", "rhg"):
        _, tspec = specs(name)
        fam, kw = SPECS[name]
        other = getattr(tapi, fam)(**{**kw, "seed": kw["seed"] + 1})
        a, b = tspec.point_plan(2).reseed(other.seed), other.point_plan(2)
        for f in POINT_FIELDS + ("gid0",):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        pa, pb = tspec.plan(2).reseed(other.seed), other.plan(2)
        for f in ("key_a", "count_a", "gid_a", "active"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f), err_msg=f)


@pytest.mark.parametrize("kind,dim", [("cube", 2), ("cube", 3), ("polar", 2)])
def test_cell_points_padding_holds_zero(kind, dim):
    """Padding slots hold 0 (the card's kernel writes the same), valid
    slots finite values; empty cells hold no point."""
    (key, count, cell, geom), scale = cell_rows(50, 7, dim, kind, seed=3)
    pts, mask = cell_points_ref(key, count, cell, geom, kind=kind, scale=scale, capacity=7,
                                dim=dim)
    assert not pts[~mask].any() and bool(torch.isfinite(pts).all())
    assert int(mask.sum()) == int(count.sum()) and not mask[count == 0].any()
