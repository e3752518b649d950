"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device, which
skips when there is none (CUDA kernels have no CPU mode).  Every
comparison is exact (``torch.equal``).  Run on a machine with an H100 and
``nvcc``: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.distrib.runtime import plan_tensors
from repro_torch.kernels import build
from repro_torch.kernels.delaunay import ops as D
from repro_torch.kernels.delaunay.ref import triangulate_ref
from repro_torch.kernels.geom import ops as G
from repro_torch.kernels.geom.ref import cell_points_ref, pair_edges_ref
from repro_torch.kernels.hist import ops as H
from repro_torch.kernels.hist.ref import hist_counts_ref
from repro_torch.kernels.pairmask import ops as M
from repro_torch.kernels.pairmask.ref import pair_mask_ref
from repro_torch.kernels.sampler import ops as S
from repro_torch.kernels.sampler.ref import chunk_decode_ref, chunk_draw_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rows(dev, R=16, cap=4096):
    g = torch.Generator(device=dev).manual_seed(1)
    key = torch.randint(-2 ** 31, 2 ** 31, (R, 2), dtype=torch.int32, device=dev, generator=g)
    uni = torch.randint(0, 2 ** 50, (R,), device=dev, generator=g)
    uni[:3] = torch.tensor([0, 1, 3 * cap // 2], device=dev)
    cnt = torch.minimum(torch.randint(0, cap + 1, (R,), device=dev, generator=g), uni)
    cnt[2] = cap
    return key, uni, cnt, cap


@pytest.mark.parametrize("t", [0, 1, 63])
def test_chunk_draw_matches_plain(cuda, t):
    key, uni, cnt, cap = _rows(cuda)
    before = build.LAUNCHES["chunk_draw"]
    assert torch.equal(S.chunk_draw(key, uni, cnt, t, cap), chunk_draw_ref(key, uni, cnt, t, cap))
    assert build.LAUNCHES["chunk_draw"] == before + 1


def test_chunk_draw_redraw_matches_plain(cuda):
    key, uni, cnt, cap = _rows(cuda)
    s = torch.sort(chunk_draw_ref(key, uni, cnt, 0, cap), dim=-1).values
    active = torch.arange(len(cnt), device=cuda) % 3 != 1
    assert torch.equal(S.chunk_draw(key, uni, cnt, 1, cap, s, active),
                       chunk_draw_ref(key, uni, cnt, 1, cap, s, active))


def test_chunk_decode_matches_plain(cuda):
    key, uni, cnt, cap = _rows(cuda)
    R = len(cnt)
    vals = torch.sort(torch.randint(0, 2 ** 40, (R, cap), device=cuda), dim=-1).values
    vals[:, :8] = torch.tensor([0, 1, 2, 3, 2 ** 52 - 1, 2 ** 52, 2 ** 52 + 1, 2 ** 62 - 1],
                               device=cuda)
    kind = torch.arange(R, device=cuda, dtype=torch.int32) % 4
    params = torch.randint(0, 2 ** 20, (R, 3), device=cuda)
    owned = torch.arange(R, device=cuda) % 2 == 0
    ea, ka = S.chunk_decode(vals, kind, params, cnt, owned)
    eb, kb = chunk_decode_ref(vals, kind, params, cnt, owned)
    assert torch.equal(ea, eb) and torch.equal(ka, kb)


@pytest.mark.parametrize("bins,log2,drop", [
    (100, False, False), (4096, False, True), (1 << 20, False, True),
    (1 << 20, False, False), (H.LOG2_BINS, True, False),
])
def test_hist_matches_plain(cuda, bins, log2, drop):
    v = torch.randint(-5, 2 * bins, (50000,), device=cuda)
    assert torch.equal(H.hist_counts(v, bins, log2=log2, drop=drop),
                       hist_counts_ref(v, bins, log2=log2, drop=drop))


def test_kernels_refuse_wrong_arguments(cuda):
    key, uni, cnt, cap = _rows(cuda)
    with pytest.raises(ValueError):
        S.chunk_draw(key.to(torch.int64), uni, cnt, 0, cap)
    with pytest.raises(ValueError):
        S.chunk_draw(key, uni, cnt, 1, cap, torch.zeros(len(cnt), cap, dtype=torch.int64,
                                                         device=cuda), None)


@pytest.mark.parametrize("spec", [api.GNM(n=3000, m=20000, seed=1),
                                  api.GNP(n=2000, p=0.005, directed=True, seed=2)])
def test_generate_and_collect_on_the_card_equal_cpu(cuda, spec):
    assert torch.equal(api.generate(spec, 2, device=cuda).edges.cpu(),
                       api.generate(spec, 2, device="cpu").edges)
    a, b = api.collect(spec, 2, device=cuda), api.collect(spec, 2, device="cpu")
    assert torch.equal(a.degree.degrees.cpu(), b.degree.degrees)
    assert torch.equal(a.degree.log2_hist.cpu(), b.degree.log2_hist)


GEOM_SPECS = [api.RGG(n=3000, radius=0.04, seed=3), api.RGG(n=2000, radius=0.09, dim=3, seed=4),
              api.RHG(n=3000, avg_deg=12.0, gamma=2.7, seed=5)]
GEOM_IDS = ["rgg2", "rgg3", "rhg"]


@pytest.mark.parametrize("tile,dim", [("euclid", 2), ("euclid", 3), ("hyp", 2)])
@pytest.mark.parametrize("batch,rows,cols", [(3, 200, 130), (2, 129, 260), (3, 1, 3),
                                             (1, 300, 131)])
def test_pair_mask_matches_plain(cuda, tile, dim, batch, rows, cols):
    """Shapes on and off the 128 x 128 tile and the 4-byte store width."""
    g = torch.Generator(device=cuda).manual_seed(7)
    dtype = torch.float32 if tile == "euclid" else torch.float64
    a = torch.rand((batch, rows, 8), dtype=dtype, device=cuda, generator=g)
    b = torch.rand((batch, cols, 8), dtype=dtype, device=cuda, generator=g)
    if tile == "hyp":
        a[..., 2:4] += 1.0
        b[..., 2:4] += 1.0
    scalar = 0.05 if tile == "euclid" else 1.3
    before = build.LAUNCHES["pair_mask"]
    got = M.pair_mask(a, b, scalar, tile=tile, dim=dim)
    assert build.LAUNCHES["pair_mask"] == before + 1
    want = pair_mask_ref(a, b, scalar, tile=tile, dim=dim)
    assert torch.equal(got, want)
    assert torch.equal(M.pair_mask(a[-1], b[-1], scalar, tile=tile, dim=dim), want[-1])
    if rows * cols > 1000:
        assert want.any() and not want.all()


def _plan_rows(plan, dev):
    return [t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev)]


@pytest.mark.parametrize("spec", GEOM_SPECS, ids=GEOM_IDS)
def test_pair_edges_matches_plain(cuda, spec):
    plan = spec.plan(3)
    rows = _plan_rows(plan, cuda)
    kw = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
    ea, ka = G.pair_edges(*rows, **kw)
    eb, kb = pair_edges_ref(*rows, **kw)
    assert torch.equal(ea, eb) and torch.equal(ka, kb) and bool(ka.any())


@pytest.mark.parametrize("spec", GEOM_SPECS, ids=GEOM_IDS)
def test_cell_points_matches_plain(cuda, spec):
    plan = spec.point_plan(3)
    rows = _plan_rows(plan, cuda)
    kw = dict(kind=plan.kind, scale=plan.scale, capacity=plan.capacity, dim=plan.dim)
    pa, ma = G.cell_points(*rows, **kw)
    pb, mb = cell_points_ref(*rows, **kw)
    assert torch.equal(pa, pb) and torch.equal(ma, mb)


@pytest.mark.parametrize("spec", GEOM_SPECS, ids=GEOM_IDS)
def test_geometric_generate_and_collect_on_the_card_equal_cpu(cuda, spec):
    a = api.generate(spec, 3, device=cuda, return_points=True)
    b = api.generate(spec, 3, device="cpu", return_points=True)
    assert torch.equal(a.edges.cpu(), b.edges)
    if isinstance(spec, api.RGG):
        assert torch.equal(a.points.cpu(), b.points)
    ca, cb = api.collect(spec, 3, device=cuda), api.collect(spec, 3, device="cpu")
    assert ca.num_edges == cb.num_edges == len(b.edges)
    assert torch.equal(ca.degree.degrees.cpu(), cb.degree.degrees)


def test_geometric_kernels_refuse_wrong_arguments(cuda):
    plan = GEOM_SPECS[0].plan(1)
    rows = _plan_rows(plan, cuda)
    kw = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
    with pytest.raises(ValueError):
        G.pair_edges(*([rows[0].to(torch.int64)] + rows[1:]), **kw)
    with pytest.raises(ValueError):
        G.pair_edges(*rows, capacity=plan.capacity, dim=4, kinds=plan.kinds_present)
    a = torch.zeros((2, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        M.pair_mask(a.double(), a.double(), 1.0, tile="euclid")
    with pytest.raises(ValueError):
        M.pair_mask(a, a, 1.0, tile="hyp")


def _dt_rows(dim, seed, B=8, N=200):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(dim + 2, N + 1, B)
    cnt[[1, 5]] = [0, N]
    pts = rng.random((B, N, dim))
    pts[2, 50:60] = pts[2, :10]                          # repeated points: not ok
    return torch.from_numpy(pts), torch.from_numpy(cnt)


@pytest.mark.parametrize("dim", [2, 3])
def test_triangulate_matches_plain(cuda, dim):
    pts, cnt = _dt_rows(dim, 70 + dim)
    N = pts.shape[1]
    kw = dict(dim=dim, num_simplices=D.simplex_capacity(N, dim),
              cavity=D.cavity_capacity(dim), group=D.group_size(dim))
    wk = torch.zeros((len(cnt), 2), dtype=torch.int64, device=cuda)
    wp = torch.zeros((len(cnt), 2), dtype=torch.int64)
    before = build.LAUNCHES["triangulate"]
    ks, ka, ko = (t.cpu() for t in D.triangulate(pts.to(cuda), cnt.to(cuda), work=wk, **kw))
    assert build.LAUNCHES["triangulate"] == before + 1
    ps, pa, po = triangulate_ref(pts, cnt, work=wp, **kw)
    assert torch.equal(ko, po) and int(po.sum()) >= 6
    assert torch.equal(ks[po], ps[po]) and torch.equal(ka[po], pa[po])
    assert torch.equal(wk.cpu()[po], wp[po])


def test_triangulate_ties_clear_ok_as_plain(cuda):
    sq = torch.tensor([[[0.2, 0.2], [0.8, 0.2], [0.8, 0.8], [0.2, 0.8]]], dtype=torch.float64)
    line = torch.stack([torch.linspace(0.1, 0.9, 5, dtype=torch.float64),
                        torch.full((5,), 0.5, dtype=torch.float64)], 1)[None]
    for pts, n in ((sq, 4), (line, 5)):
        cnt = torch.tensor([n])
        _, _, ok = D.batched_delaunay(pts.to(cuda), cnt.to(cuda), dim=2, device=cuda)
        assert not bool(ok[0])


@pytest.mark.parametrize("dim", [2, 3])
def test_circumspheres_matches_plain(cuda, dim):
    s = torch.rand((50000, dim + 1, dim), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(dim))
    s[0, 1] = s[0, 0]
    before = build.LAUNCHES["circumspheres"]
    got = D.circumspheres(s.to(cuda))
    assert build.LAUNCHES["circumspheres"] == before + 1
    for g, w in zip(got, D.circumspheres(s)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kw", [dict(n=3000, seed=8), dict(n=2100, dim=3, seed=9)],
                         ids=["rdg2", "rdg3"])
def test_rdg_on_the_card_equals_cpu(cuda, kw):
    from repro_torch.core import rdg

    spec = api.RDG(**kw)
    plan = spec.plan(3, device=cuda)
    rdg.rdg_structure.cache_clear()
    cpu_plan = spec.plan(3, device="cpu")
    rdg.rdg_structure.cache_clear()
    for f in ("gid_a", "gid_b", "geom_a", "geom_b", "active"):
        assert np.array_equal(getattr(plan, f), getattr(cpu_plan, f)), f
    rows = _plan_rows(plan, cuda)
    kwp = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
    ea, ka = G.pair_edges(*rows, **kwp)
    eb, kb = pair_edges_ref(*rows, **kwp)
    assert torch.equal(ea, eb) and torch.equal(ka, kb) and bool(ka.any())
    a = api.generate(spec, 3, device=cuda, return_points=True)
    b = api.generate(spec, 3, device="cpu", return_points=True)
    assert torch.equal(a.edges.cpu(), b.edges) and torch.equal(a.points.cpu(), b.points)
