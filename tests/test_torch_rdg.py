"""RDG in the port against the JAX package: the grid, the whole-grid point
bank, the point plan, the planning structure's columns, the GEOM_CERT
rows of the pair program, ``generate``, ``iter_edge_chunks``,
``collect`` and ``return_points``.

The port runs on the CPU (``device="cpu"``), where the triangulation,
certificate and pair-edge wrappers compute their plain versions.  Every
comparison is exact.  The reference is held through its own device
triangulation (``rdg_pair_plan`` run by its engine), never through the
Qhull union ``rdg_union``, which depends on P near cocircular points.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import stats as jstats
from repro.core import rdg as jrdg
from repro.core import rgg as jrgg
from repro.distrib import engine as jeng
from repro.distrib import runtime as jrt
from repro_torch import api as tapi
from repro_torch.core import rdg as trdg
from repro_torch.core import rgg as trgg
from repro_torch.distrib import engine as teng
from repro_torch.distrib import runtime as trt
from repro_torch.kernels.delaunay.predicates import circumsphere, sqrt_rn

torch.set_num_threads(1)

SPECS = {
    "rdg2": dict(n=512, seed=3),
    "rdg2-chunks": dict(n=600, seed=5, chunks=4),
    "rdg3": dict(n=128, dim=3, seed=4),              # wrapping regions: the Qhull path
}
PAIR_FIELDS = teng._PAIR_INPUTS
POINT_FIELDS = ("key_data", "count", "cell", "geom")

_REF: dict = {}


def ref_generate(name, P):
    if (name, P) not in _REF:
        g = japi.generate(japi.RDG(**SPECS[name]), P, return_points=True)
        _REF[name, P] = (np.asarray(g.edges), np.asarray(g.points))
    return _REF[name, P]


def assert_columns_equal(got, want):
    assert got[0] == want[0] > 0
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dim,P", [(2, 1), (2, 20), (3, 1), (3, 9)])
def test_grid_and_local_cells_match_reference(dim, P):
    for n in (512, 5000):
        jg = jrdg.rdg_grid(n, jrdg.default_chunk_P(P, dim), dim)
        tg = trdg.rdg_grid(n, trdg.default_chunk_P(P, dim), dim)
        assert (tg.dim, tg.g, tg.cpd, tg.rho) == (jg.dim, jg.g, jg.cpd, jg.rho)
        for pe in (0, P - 1):
            assert trgg.local_cells_for_pe(tg, P, pe) == jrgg.local_cells_for_pe(jg, P, pe)
        assert tg.chunk_cells((1,) * dim) == jg.chunk_cells((1,) * dim)


@pytest.mark.parametrize("n,dim", [(512, 2), (700, 3)])
def test_grid_bank_matches_reference(n, dim):
    js = jrdg.RdgStructure(n, 1, dim)
    ts = trdg.RdgStructure(n, 1, dim)
    jb = jrdg._GridBank(11, js.grid, n, js._tree)
    tb = trdg._GridBank(11, ts.grid, n, ts._tree, device="cpu")
    # the bank's valid slots; padding holds 0 in the port (the cell
    # program's defined value), the reference's draws there
    valid = np.arange(tb._pos.shape[1])[None, :] < tb._counts[:, None]
    np.testing.assert_array_equal(tb._pos[valid], jb._pos[valid])
    assert not tb._pos[~valid].any()
    cells = sorted(ts._init_regions[1])
    for got, want in zip(tb.region(cells, ts.chunk_cells[1]), jb.region(cells, js.chunk_cells[1])):
        np.testing.assert_array_equal(got, want)
    for cell in ((-1,) * dim, (js.grid.g,) * dim, (0,) * dim):
        for got, want in zip(tb.get(cell), jb.get(cell)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("name", ["rdg2", "rdg3"])
def test_point_plan_matches_reference(name, P):
    jspec, tspec = japi.RDG(**SPECS[name]), tapi.RDG(**SPECS[name])
    ref, got = jspec.point_plan(P), tspec.point_plan(P)
    for f in POINT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert (got.kind, got.scale, got.dim, got.capacity) == (ref.kind, ref.scale, ref.dim,
                                                            ref.capacity)
    assert got.reseed(9).count.sum() == tspec.n


@pytest.mark.parametrize("n,P,dim", [(512, 1, 2), (512, 2, 2), (512, 8, 2), (128, 1, 3),
                                     (2100, 1, 3)])
def test_structure_columns_match_reference(n, P, dim):
    """2-D at n = 512 runs the batched triangulation; 3-D at n = 128 only
    the Qhull path of wrapping regions; 3-D at n = 2100 one batched round
    of 8 rows, then Qhull for the chunks it did not certify."""
    js, ts = jrdg.RdgStructure(n, P, dim), trdg.RdgStructure(n, P, dim)
    assert_columns_equal(ts._columns(7, "cpu"), js._columns(7))
    assert ts.last_rounds == (0 if (n, dim) == (128, 3) else 1)


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_pair_plan_tables_match_reference(name, P):
    ref = japi.RDG(**SPECS[name]).plan(P)
    got = tapi.RDG(**SPECS[name]).plan(P, device="cpu")
    for f in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
    assert (got.capacity, got.dim, got.rng_impl, got.kinds_present) == (
        ref.capacity, ref.dim, ref.rng_impl, ref.kinds_present) == (4, ref.dim, "threefry2x32",
                                                                     (jeng.GEOM_CERT,))


@pytest.mark.parametrize("name", ["rdg2", "rdg3"])
def test_pair_fn_matches_reference_on_its_cert_tables(name):
    ref = japi.RDG(**SPECS[name]).plan(2)
    payload, keep, _ = jrt.run(ref)
    plan = teng.pair_plan_from_arrays({f: getattr(ref, f) for f in PAIR_FIELDS},
                                      ref.capacity, ref.dim)
    tp, tk = trt.run(plan, "cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(payload))
    assert np.asarray(keep).any()


@pytest.mark.parametrize("dim", [2, 3])
def test_cert_rows_with_boxes_on_the_sphere_match_the_engine(dim):
    """The engine's certificate with each row's box set exactly on the
    port's computed circumsphere, or one ulp in or out: the reference's
    jitted pair program and the port's agree row by row."""
    rng = np.random.default_rng(60 + dim)
    k, G = 2000, (dim + 1) * dim
    simp = rng.random((k, dim + 1, dim))
    c, r2, _ = circumsphere(torch.from_numpy(simp))
    rad = sqrt_rn(r2).numpy()[:, None]
    box = np.concatenate([c.numpy() - rad, c.numpy() + rad], axis=1)
    mode = rng.integers(0, 3, box.shape)
    box = np.where(mode == 1, np.nextafter(box, np.inf),
                   np.where(mode == 2, np.nextafter(box, -np.inf), box))
    gid_a = np.zeros((k, 4), np.int64)
    gid_a[:, :dim + 1] = rng.integers(0, 10 ** 6, (k, dim + 1))
    gid_b = np.zeros((k, 4), np.int64)
    gid_b[:, 0] = rng.integers(1, 64, k)
    geom_b = np.ones((k, G))
    geom_b[:, :2 * dim] = box
    dpl = np.full(k, dim + 1)
    cols = (np.full(k, jeng.GEOM_CERT, np.int32), np.zeros((k, 2), np.uint32),
            np.zeros((k, 2), np.uint32), dpl, dpl, gid_a, gid_b, simp.reshape(k, G), geom_b,
            np.zeros((k, 1)), np.ones(k, bool))
    ref = jeng.pair_plan_from_columns(2, np.arange(k) % 2, *cols, capacity=4, dim=dim)
    got = teng.pair_plan_from_columns(2, np.arange(k) % 2, *cols, capacity=4, dim=dim)
    _, keep, _ = jrt.run(ref)
    tp, tk = trt.run(got, "cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keep))
    certified = np.asarray(keep).any(axis=-1)
    assert 0.05 < certified.mean() < 0.95


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_matches_reference(name, P):
    g = tapi.generate(tapi.RDG(**SPECS[name]), P, device="cpu", return_points=True)
    edges, points = ref_generate(name, P)
    assert g.edges.dtype == torch.int64 and (g.n, g.directed) == (SPECS[name]["n"], False)
    np.testing.assert_array_equal(g.edges.numpy(), edges)
    np.testing.assert_array_equal(g.points.numpy(), points)


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", ["rdg2", "rdg3"])
def test_stream_regrouped_by_pe_matches_reference(name, P):
    tspec = tapi.RDG(**SPECS[name])
    per_pe: dict = {}
    for ch in tapi.iter_edge_chunks(tspec, P, device="cpu", batch=32):
        assert ch.count is None and ch.buffer.shape[1:] == (16, 2)
        per_pe.setdefault(ch.pe, []).append(ch.edges())
    got = torch.cat([torch.cat(per_pe[pe]) for pe in sorted(per_pe)])
    np.testing.assert_array_equal(got.numpy(), ref_generate(name, P)[0])


@pytest.mark.parametrize("name", ["rdg2", "rdg3"])
def test_iter_points_match_reference(name):
    jspec, tspec = japi.RDG(**SPECS[name]), tapi.RDG(**SPECS[name])
    want = np.concatenate([c.points() for c in japi.iter_points(jspec, 3, batch=16)])
    got = torch.cat([c.points() for c in tapi.iter_points(tspec, 3, device="cpu", batch=16)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["rdg2", "rdg3"])
def test_collect_matches_reference(name):
    want = jstats.collect(japi.RDG(**SPECS[name]), 3)
    got = tapi.collect(tapi.RDG(**SPECS[name]), 3, device="cpu", batch=40)
    assert got.num_edges == want.num_edges == len(ref_generate(name, 3)[0])
    np.testing.assert_array_equal(got.degree.degrees.numpy(), np.asarray(want.degree.degrees))
    for f in ("deg_sum", "deg_sumsq", "deg_max", "num_isolated"):
        assert getattr(got.degree, f) == getattr(want.degree, f), f


def test_a_torus_triangulation_has_3n_edges_and_reseeds():
    """2-D: a triangulation of the torus has exactly 3n edges (Euler), no
    loops, no duplicates; the plan's reseed equals a cold plan."""
    tspec = tapi.RDG(n=700, seed=12)
    e = tapi.generate(tspec, 2, device="cpu").edges
    assert len(e) == 3 * tspec.n and bool((e[:, 0] > e[:, 1]).all())
    assert len(torch.unique(e[:, 0] * tspec.n + e[:, 1])) == len(e)
    plan = tspec.plan(2, device="cpu")
    re = plan.reseed(13)
    cold = tapi.RDG(n=700, seed=13).plan(2, device="cpu")
    for f in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(re, f), getattr(cold, f), err_msg=f)


def test_plans_take_a_device_and_cuda_without_a_gpu_raises(monkeypatch):
    for spec in (tapi.GNM(n=100, m=50), tapi.RGG(n=100, radius=0.1),
                 tapi.RHG(n=100, avg_deg=4, gamma=2.5)):
        spec.plan(2, device="cpu")                   # the other families ignore it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.RDG(n=300, seed=1).plan(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.generate(tapi.RDG(n=300, seed=1), 1)
