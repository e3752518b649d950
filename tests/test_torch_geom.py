"""RGG and RHG in the port against the JAX package: plans, the candidate-
pair program, ``generate``, ``iter_edge_chunks`` and ``collect``.

The port runs on the CPU (``device="cpu"``), where the ``pair_edges``
wrapper computes its plain PyTorch version.  Edges, keep masks, plan
tables and RHG's hyperbolic features are compared exactly: the features
go through the same ``exp``, ``expm1``, ``log1p``, ``log``, ``sin`` and
``cos`` as the reference's compiled program
(``repro_torch.kernels.geom.libm``).
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import stats as jstats
from repro.distrib import engine as jeng
from repro.distrib import runtime as jrt
from repro_torch import api as tapi
from repro_torch.distrib import engine as teng
from repro_torch.distrib import runtime as trt
from repro_torch.kernels.geom.ref import hyp_features
from repro_torch.kernels.geom.ref import GEOM_EMPTY, pair_edges_ref
from torch_geom_rows import ALL_KINDS, pair_rows
from torch_golden import jax_hyp_features

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

SPECS = {
    "rgg2": ("RGG", dict(n=3000, radius=0.04, seed=41)),
    "rgg3": ("RGG", dict(n=2500, radius=0.09, dim=3, seed=42)),
    "rhg": ("RHG", dict(n=3000, avg_deg=10, gamma=2.6, seed=43)),
    "rhg-steep": ("RHG", dict(n=4096, avg_deg=16, gamma=2.8, seed=44)),
}
PAIR_FIELDS = teng._PAIR_INPUTS

_REF: dict = {}


def ref_generate(name, P):
    if (name, P) not in _REF:
        fam, kw = SPECS[name]
        _REF[name, P] = np.asarray(japi.generate(getattr(japi, fam)(**kw), P).edges)
    return _REF[name, P]


def specs(name):
    fam, kw = SPECS[name]
    return getattr(japi, fam)(**kw), getattr(tapi, fam)(**kw)


def port_plan_of(ref):
    return teng.pair_plan_from_arrays({f: getattr(ref, f) for f in PAIR_FIELDS},
                                      ref.capacity, ref.dim)


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_pair_plan_tables_match_reference(name, P):
    jspec, tspec = specs(name)
    ref, got = jspec.plan(P), tspec.plan(P)
    assert isinstance(got, teng.PairPlan)
    for f in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
    assert (got.capacity, got.dim, got.rng_impl) == (ref.capacity, ref.dim, ref.rng_impl)
    assert got.kinds_present == ref.kinds_present
    assert got.total_pairs == ref.total_pairs


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pair_fn_matches_reference_on_its_tables(name):
    jspec, _ = specs(name)
    ref = jspec.plan(2)
    payload, keep, _ = jrt.run(ref)
    payload, keep = np.asarray(payload), np.asarray(keep)
    tp, tk = trt.run(port_plan_of(ref), "cpu")
    assert tp.dtype == torch.int64 and tk.dtype == torch.bool
    assert tuple(tp.shape) == payload.shape and tuple(tk.shape) == keep.shape
    np.testing.assert_array_equal(tk.numpy(), keep)
    np.testing.assert_array_equal(tp.numpy(), payload)
    assert keep.any()


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_matches_reference(name, P):
    _, tspec = specs(name)
    g = tapi.generate(tspec, P, device="cpu")
    want = ref_generate(name, P)
    assert g.edges.dtype == torch.int64 and g.points is None
    assert (g.n, g.directed, g.m) == (tspec.n, False, len(want))
    np.testing.assert_array_equal(g.edges.numpy(), want)


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_stream_regrouped_by_pe_matches_reference(name, P):
    _, tspec = specs(name)
    plan = tspec.plan(P)
    per_pe: dict = {}
    for ch in tapi.iter_edge_chunks(tspec, P, device="cpu", batch=64):
        assert ch.count is None                       # pair rows carry no count
        assert ch.buffer.shape[1:] == (plan.capacity ** 2, 2)
        assert ch.mask.shape == ch.buffer.shape[:2] and ch.buffer.shape[0] <= 64
        per_pe.setdefault(ch.pe, []).append(ch.edges())
    got = torch.cat([torch.cat(per_pe[pe]) for pe in sorted(per_pe)])
    np.testing.assert_array_equal(got.numpy(), ref_generate(name, P))


def test_unbatched_stream_matches_reference_stream():
    jspec, tspec = specs("rgg2")
    want = [(c.pe, np.asarray(c.mask), np.asarray(c.buffer))
            for c in japi.iter_edge_chunks(jspec, 2, batch=32)]
    got = list(tapi.iter_edge_chunks(tspec, 2, device="cpu", batch=32))
    assert len(got) == len(want)
    for g, (pe, mask, buf) in zip(got, want):
        assert g.pe == pe
        np.testing.assert_array_equal(g.mask.numpy(), mask)
        np.testing.assert_array_equal(g.buffer.numpy()[mask], buf[mask])
    one = next(tapi.iter_edge_chunks(tspec, 2, device="cpu"))
    assert one.buffer.shape == (tspec.plan(2).capacity ** 2, 2) and one.mask.ndim == 1


def test_rhg_features_within_tolerance():
    """The features of every active row's side-a slots equal the
    reference decode's bit for bit: the tolerance is 0."""
    jspec, _ = specs("rhg-steep")
    plan = jspec.plan(1)
    rows = np.argwhere(plan.active[0])[:, 0]
    kd, geom = plan.key_a[0, rows], plan.geom_a[0, rows]
    alpha = plan.fparams[0, rows, 0]
    N = plan.capacity
    want = np.asarray(jax.jit(jax.vmap(lambda k, g, s: jax_hyp_features(k, g, s, N)))(
        kd, geom, alpha))
    got = hyp_features(torch.from_numpy(kd.astype(np.int64)), torch.from_numpy(geom),
                       torch.from_numpy(alpha), N).numpy()
    np.testing.assert_array_equal(got, want[..., :4])


@pytest.mark.parametrize("name", ["rhg", "rhg-steep"])
def test_rhg_radii_of_iter_points_equal_run_points(name):
    """The radii (and angles) of ``iter_points`` equal the reference's
    ``engine.run_points`` on every valid slot, in plan order."""
    jspec, tspec = specs(name)
    pts, mask, _ = jeng.run_points(jspec.point_plan(1))
    want = np.asarray(pts)[np.asarray(mask)]            # pe-major, cell, slot: stream order
    got = torch.cat([c.points() for c in tapi.iter_points(tspec, 1, device="cpu", batch=64)])
    assert len(want) == tspec.n
    np.testing.assert_array_equal(got.numpy()[:, 0], want[:, 0])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_collect_matches_reference(name):
    jspec, tspec = specs(name)
    want = jstats.collect(jspec, 3)
    got = tapi.collect(tspec, 3, device="cpu", batch=40)
    assert got.num_edges == want.num_edges == len(ref_generate(name, 3))
    np.testing.assert_array_equal(got.degree.degrees.numpy(), np.asarray(want.degree.degrees))
    np.testing.assert_array_equal(got.degree.log2_hist.numpy(), np.asarray(want.degree.log2_hist))
    for f in ("deg_sum", "deg_sumsq", "deg_max", "num_isolated"):
        assert getattr(got.degree, f) == getattr(want.degree, f), f


def test_collect_counts_streamed_edges_of_pair_rows():
    """Repair: ``collect`` added ``chunk.count``, which a candidate-pair
    row cannot know before its test runs; counting ``len(edges)`` is what
    the reference does."""
    _, tspec = specs("rgg2")
    chunk = next(tapi.iter_edge_chunks(tspec, 2, device="cpu"))
    with pytest.raises(TypeError):
        0 + chunk.count                               # the old sum
    rep = tapi.collect(tspec, 2, device="cpu")
    assert rep.num_edges == len(ref_generate("rgg2", 2))
    assert rep.degree.deg_sum == 2 * rep.num_edges


def test_run_serves_pair_and_point_plans():
    _, tspec = specs("rhg")
    plan = tspec.plan(3)
    payload, keep = trt.run(plan, "cpu")
    assert payload.shape == (3, plan.pairs_per_pe, plan.capacity ** 2, 2)
    pts, mask = trt.run(tspec.point_plan(3), "cpu")
    assert pts.shape[:2] == mask.shape[:2] == (3, tspec.point_plan(3).count.shape[1])
    assert int(mask.sum()) == tspec.n


def test_p_invariance():
    for name in ("rgg2", "rhg"):
        want = ref_generate(name, 1)
        for P in (2, tapi.DEFAULT_CHUNKS):
            e = tapi.generate(specs(name)[1], P, device="cpu").edges.numpy()
            np.testing.assert_array_equal(np.sort(e[:, 0] * 10 ** 6 + e[:, 1]),
                                          np.sort(want[:, 0] * 10 ** 6 + want[:, 1]))


def test_edges_are_canonical_and_within_reach():
    _, tspec = specs("rgg2")
    g = tapi.generate(tspec, 2, device="cpu", return_points=True)
    e, p = g.edges, g.points
    assert bool((e[:, 0] > e[:, 1]).all())
    d2 = ((p[e[:, 0]].float() - p[e[:, 1]].float()) ** 2).sum(-1)
    assert bool((d2 <= tspec.radius ** 2 * (1 + 1e-6)).all())


def test_cert_rows_and_non_counter_rngs_raise():
    """A GEOM_CERT row beside GEOM_TORUS rows runs (RDG is ported) and
    equals the reference on the same table; non-counter key impls still
    raise."""
    jspec, _ = specs("rgg2")
    ref = jspec.plan(1)
    tables = {f: getattr(ref, f).copy() for f in PAIR_FIELDS}
    for f in ("geom_a", "geom_b"):        # room for a 2-D simplex and its box
        tables[f] = np.concatenate([tables[f], np.ones(tables[f].shape[:2] + (4,))], axis=2)
    tables["kind"][0, 0] = jeng.GEOM_CERT
    tables["geom_a"][0, 0] = [0.30, 0.30, 0.45, 0.32, 0.33, 0.41]
    tables["geom_b"][0, 0, :4] = [0.0, 0.0, 1.0, 1.0]
    tables["gid_b"][0, 0, 0] = 0b1011
    want = jeng.PairPlan(**tables, capacity=ref.capacity, dim=ref.dim)
    payload, keep, _ = jrt.run(want)
    tp, tk = trt.run(teng.pair_plan_from_arrays(tables, ref.capacity, ref.dim), "cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(payload))
    assert bool(tk[0, 0].any())
    with pytest.raises(ValueError, match="counter"):
        teng.require_counter_rng("rbg")
    with pytest.raises(ValueError):
        tapi.generate(specs("rhg")[1], 1, device="cpu", rng_impl="rbg")


def test_make_pair_plan_matches_reference():
    rng = np.random.default_rng(4)

    def spec(kind, mod):
        k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        return mod.PairSpec(kind, k, k[::-1], int(rng.integers(1, 9)), int(rng.integers(1, 9)),
                            int(rng.integers(0, 100)), int(rng.integers(0, 100)),
                            tuple(rng.random(4)), tuple(rng.random(4)),
                            fparams=(1.5, math.cosh(7.0)), self_pair=bool(rng.integers(2)))

    rows = [[1, 1, 1], [], [1]]
    state = rng.bit_generator.state
    ref = jeng.make_pair_plan([[spec(jeng.GEOM_HYP, jeng) for _ in r] for r in rows])
    rng.bit_generator.state = state
    got = teng.make_pair_plan([[spec(teng.GEOM_HYP, teng) for _ in r] for r in rows])
    for f in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.capacity == ref.capacity
    assert teng.pair_slot_index(2, 5, 8) == jeng.pair_slot_index(2, 5, 8)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("rgg2", "rhg"):
        _, tspec = specs(name)
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.generate(tspec, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            next(tapi.iter_edge_chunks(tspec, 1, device="cuda"))
        with pytest.raises(RuntimeError, match="CUDA"):
            next(tapi.iter_points(tspec, 1))
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.collect(tspec, 1)


@pytest.mark.parametrize("cap,dim", [(4, 2), (24, 3)])
def test_synthetic_pair_rows_keep_edges_of_every_kind(cap, dim):
    """The mixed rows that the card tests hand ``pair_edges`` exercise
    every kind: each keeps edges, EMPTY and inactive rows none."""
    rows = pair_rows(600, cap, dim, seed=cap + dim)
    edges, keep = pair_edges_ref(*rows, capacity=cap, dim=dim, kinds=ALL_KINDS)
    kind, active = rows[0], rows[-1]
    for k in ALL_KINDS:
        assert bool(keep[kind == k].any()), k
    assert not keep[kind == GEOM_EMPTY].any() and not keep[~active].any()
    assert bool((edges[..., 0] >= edges[..., 1]).all())
