"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device, which
skips when there is none (CUDA kernels have no CPU mode).  Every
comparison is exact (``torch.equal``).  Run on a machine with an H100 and
``nvcc``: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.sampling import sample_rows
from repro_torch.distrib.runtime import plan_tensors
from repro_torch.kernels import build
from repro_torch.kernels.delaunay import ops as D
from repro_torch.kernels.delaunay.ref import triangulate_ref
from repro_torch.kernels.geom import ops as G
from repro_torch.kernels.geom.ref import (GEOM_CERT, GEOM_HYP, GEOM_TORUS, cell_points_ref,
                                          pair_edges_ref)
from repro_torch.kernels.hist import ops as H
from repro_torch.kernels.hist.ref import hist_counts_ref
from repro_torch.kernels.pairmask import ops as M
from repro_torch.kernels.pairmask.ref import pair_mask_ref
from repro_torch.kernels.sampler import ops as S
from repro_torch.kernels.sampler.ref import (chunk_ba_ref, chunk_decode_ref, chunk_rmat_ref,
                                             sample_rows_ref)
from repro_torch.kernels.wedges import ops as W
from repro_torch.kernels.wedges.ref import close_wedges_ref, close_wedges_table_ref
from torch_dt_rows import overflow_row, tie_rows
from torch_family_rows import chunk_rows, wedge_inputs
from torch_geom_rows import ALL_KINDS, cell_rows, pair_rows
from torch_libm_inputs import INPUTS
from torch_sampler_rows import sampler_rows

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


# (rows, capacity): rows of every path at 2^16 slots (the universe-3 row's
# buckets outgrow shared memory), capacities off the bucket, tile and
# block sizes, one slot, and 200 rows of 4096
SAMPLE_SHAPES = [(64, 65536), (37, 8193), (5, 777), (3, 1), (200, 4096)]


@pytest.mark.parametrize("bucket_cap,list_cap", [(8192, 1024), (64, 4), (8192, 0)],
                         ids=["default", "merge-sorted-buckets", "unlisted-rounds"])
@pytest.mark.parametrize("R,cap", SAMPLE_SHAPES, ids=str)
def test_chunk_sample_matches_plain(cuda, R, cap, bucket_cap, list_cap):
    """The sampler equals its plain version (draws, torch.sort rounds),
    rounds per row included; small bucket and list caps send the rows
    through the kernel's paths for buckets past shared memory (merged in
    global memory) and for rows with more duplicates than it lists."""
    key, uni, cnt = sampler_rows(R, cap, R + cap, cuda)
    rounds, want_rounds = (torch.full((R,), -1, dtype=torch.int32, device=cuda) for _ in range(2))
    before = build.LAUNCHES["chunk_sample"]
    got = S.chunk_sample(key, uni, cnt, cap, rounds, bucket_cap=bucket_cap, list_cap=list_cap)
    assert build.LAUNCHES["chunk_sample"] == before + 1
    want = sample_rows_ref(key, uni, cnt, cap, want_rounds)
    assert torch.equal(got, want)
    assert torch.equal(rounds, want_rounds)
    if R >= 8 and cap >= 4096:
        assert int(rounds.max()) == 63 and int(rounds.min()) == 0


def test_chunk_sample_long_rows_match_plain(cuda):
    """Rows of 2^24 + 3 slots, a streamed wave's: 8192 buckets, the
    largest count a row may have, and a first redraw round that moves a
    stretch of millions of values (the row of 2^40 draws has about 128
    duplicates)."""
    key, _, _ = sampler_rows(2, 1, 7, cuda)
    cap = (1 << 24) + 3
    uni = torch.tensor([2 ** 44, 2 ** 40], device=cuda)
    cnt = torch.tensor([cap, cap - 1000], device=cuda)
    rounds, want_rounds = (torch.zeros(2, dtype=torch.int32, device=cuda) for _ in range(2))
    got = S.chunk_sample(key, uni, cnt, cap, rounds)
    assert torch.equal(got, sample_rows_ref(key, uni, cnt, cap, want_rounds))
    assert torch.equal(rounds, want_rounds) and int(rounds[1]) >= 1


def test_sample_rows_makes_no_host_sync(cuda):
    """On the card sample_rows reads nothing back on the host."""
    key, uni, cnt = sampler_rows(16, 4096, 3, cuda)
    S.chunk_sample(key, uni, cnt, 4096)         # built and loaded before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sample_rows(key, uni, cnt, 4096)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, sample_rows_ref(key, uni, cnt, 4096))


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


@pytest.mark.parametrize("bins", [1 << 22, 8192, 1000])
def test_bincount_ids_runs_drops_and_alignment(cuda, bins):
    """Runs of equal ids (one aggregated atomic per run in a warp),
    negative ids and ids past the end (dropped), and views that start off
    the 16-byte load width or have an odd length."""
    g = torch.Generator(device=cuda).manual_seed(bins)
    runs = torch.randint(-3, bins + 3, (20000,), device=cuda, generator=g)
    ids = torch.repeat_interleave(runs, torch.randint(1, 40, (20000,), device=cuda, generator=g))
    ids[::7] = torch.randint(-2 ** 40, -1, ids[::7].shape, device=cuda, generator=g)
    ids[3::11] = bins + torch.randint(0, 2 ** 40, ids[3::11].shape, device=cuda, generator=g)
    edges = torch.stack([torch.sort(runs).values, runs.flip(0)], 1).reshape(-1)
    for v in (ids, ids[1:], ids[1:-2], ids[:1], ids[1:2], edges, edges[3:]):
        acc = torch.full((bins,), 5, dtype=torch.int64, device=cuda)
        got = H.bincount_ids(v, bins, out=acc)
        assert got is acc
        assert torch.equal(got - 5, hist_counts_ref(v, bins, drop=True))


def test_kernels_refuse_wrong_arguments(cuda):
    key, uni, cnt, cap = _rows(cuda)
    with pytest.raises(ValueError):
        S.chunk_sample(key.to(torch.int64), uni, cnt, cap)
    with pytest.raises(ValueError):
        S.chunk_sample(key, uni, cnt, cap, torch.zeros(len(cnt), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        S.chunk_sample(key, uni, cnt, cap, bucket_cap=8193)


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
    assert torch.equal(a.points.cpu(), b.points)          # RHG radii too, bit for bit
    ca, cb = api.collect(spec, 3, device=cuda), api.collect(spec, 3, device="cpu")
    assert ca.num_edges == cb.num_edges == len(b.edges)
    assert torch.equal(ca.degree.degrees.cpu(), cb.degree.degrees)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_device_libm_equals_plain(cuda, name):
    """Each device function of libm.cuh equals its plain version on the
    card and on the CPU, bit for bit, on 10^6 inputs and its boundaries."""
    x = torch.from_numpy(INPUTS[name](np.random.default_rng(17)))
    got = G.libm_eval(name, x.to(cuda))
    assert torch.equal(got.view(torch.int64), G.LIBM_FUNCTIONS[name](x.to(cuda)).view(torch.int64))
    assert torch.equal(got.cpu().view(torch.int64), G.LIBM_FUNCTIONS[name](x).view(torch.int64))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("cap", [1, 2, 4, 16, 24])
def test_pair_edges_mixed_rows_match_plain(cuda, cap, dim):
    """TORUS, HYP, CERT and EMPTY rows in one launch, with self pairs,
    inactive rows, empty and full cells; one row, and row counts that are
    no multiple of a tile's rows."""
    for R in (1, 37, 1000):
        rows = pair_rows(R, cap, dim, seed=100 * cap + 10 * dim + R, device=cuda)
        kw = dict(capacity=cap, dim=dim, kinds=ALL_KINDS)
        before = build.LAUNCHES["pair_edges"]
        ea, ka = G.pair_edges(*rows, **kw)
        assert build.LAUNCHES["pair_edges"] == before + 1
        eb, kb = pair_edges_ref(*rows, **kw)
        assert torch.equal(ea, eb) and torch.equal(ka, kb), (cap, dim, R)


@pytest.mark.parametrize("kinds", [(GEOM_HYP,), (GEOM_TORUS,), (GEOM_CERT,),
                                   (GEOM_HYP, GEOM_CERT), ()])
def test_pair_edges_runs_only_the_kinds_it_is_given(cuda, kinds):
    rows = pair_rows(500, 24, 2, seed=5, device=cuda)
    ea, ka = G.pair_edges(*rows, capacity=24, dim=2, kinds=kinds)
    eb, kb = pair_edges_ref(*rows, capacity=24, dim=2, kinds=kinds)
    assert torch.equal(ea, eb) and torch.equal(ka, kb)


def _ref_in_parts(rows, kw, step):
    """pair_edges_ref over ``step`` rows at a time, concatenated."""
    parts = [pair_edges_ref(*(t[i:i + step] for t in rows), **kw)
             for i in range(0, len(rows[0]), step)]
    return torch.cat([e for e, _ in parts]), torch.cat([k for _, k in parts])


# capacities past the one-row staged tile (HYP from 128, TORUS from 142:
# keep bytes stored as computed), up to one shared-memory half a row (HYP
# from 1815), and the largest a launch takes (HYP 3630, TORUS 7261), with
# rows enough at 1815 (140) that a CTA takes a second tile
WIDE = [(ALL_KINDS, 128, 37), (ALL_KINDS, 144, 37), (ALL_KINDS, 208, 37),
        (ALL_KINDS, 256, 37), (ALL_KINDS, 300, 37), ((GEOM_HYP,), 127, 37),
        ((GEOM_HYP,), 128, 37), ((GEOM_HYP,), 208, 37), ((GEOM_HYP,), 1815, 140),
        ((GEOM_HYP,), 3630, 1), ((GEOM_TORUS,), 141, 37), ((GEOM_TORUS,), 142, 37),
        ((GEOM_TORUS,), 144, 37), ((GEOM_TORUS,), 256, 37), ((GEOM_TORUS,), 7261, 1)]


@pytest.mark.parametrize("kinds,cap,R", WIDE, ids=[f"{''.join(map(str, k))}-{c}"
                                                    for k, c, _ in WIDE])
def test_pair_edges_wide_rows_match_plain(cuda, kinds, cap, R):
    for dim in (2, 3):
        rows = pair_rows(R, cap, dim, seed=cap + dim, device=cuda, kinds=kinds)
        rows[-1][:R // 2 + 1] = True                     # the first rows run
        assert any(int(k) in kinds for k in rows[0][:R // 2 + 1])
        kw = dict(capacity=cap, dim=dim, kinds=kinds)
        ea, ka = G.pair_edges(*rows, **kw)
        eb, kb = _ref_in_parts(rows, kw, max(1, (1 << 24) // (cap * cap)))
        assert torch.equal(ea, eb) and torch.equal(ka, kb), (kinds, cap, dim, R)
        del ea, ka, eb, kb
        torch.cuda.empty_cache()


def test_registry_cases_are_clean_under_sync_debug(cuda):
    """Every program of ``repro_torch.analyze``'s registry on the card,
    under the op scan and ``set_sync_debug_mode("error")``: no finding,
    and the kernel cases launch ``pair_mask`` and ``triangulate``."""
    from repro_torch.analyze import programs

    before = dict(build.LAUNCHES)
    reports = programs.scan_programs(device=cuda)
    bad = [(r.name, r.error, [f.to_json() for f in r.scan.findings])
           for r in reports if not r.ok]
    assert not bad, bad
    assert torch.cuda.get_sync_debug_mode() == 0
    for name in ("pair_mask", "triangulate", "pair_edges", "chunk_sample"):
        assert build.LAUNCHES[name] > before[name], name


# the RHG wave's capacity (HYP rows), the RGG generate plan's (TORUS
# rows), the RDG plan's (CERT rows) and all three mixed
INSTANCE_SHAPES = [((GEOM_HYP,), 24, 2), ((GEOM_TORUS,), 24, 2), ((GEOM_CERT,), 4, 2),
                   (ALL_KINDS, 24, 3)]


@pytest.mark.parametrize("kinds,cap,dim", INSTANCE_SHAPES,
                         ids=[f"{''.join(map(str, k))}-{c}-{d}" for k, c, d in INSTANCE_SHAPES])
def test_pair_edges_both_instances_match_plain(cuda, kinds, cap, dim):
    """The instances without a stage (every path but serving) and with a
    stage below the capacity (a serving slab's) on the same rows, whose
    counts stay below the capacity so that both apply."""
    rows = pair_rows(4000, cap, dim, seed=7 * cap + dim, device=cuda, kinds=kinds)
    rows[3].clamp_(max=cap - 1)
    rows[4].clamp_(max=cap - 1)
    kw = dict(capacity=cap, dim=dim, kinds=kinds)
    eb, kb = pair_edges_ref(*rows, **kw)
    assert bool(kb.any())
    for stage in (None, {GEOM_HYP: cap - 1, GEOM_TORUS: cap - 1}):
        ea, ka = G.pair_edges(*rows, stage=stage, **kw)
        assert torch.equal(ea, eb) and torch.equal(ka, kb), stage


@pytest.mark.parametrize("kind,dim", [("cube", 2), ("cube", 3), ("polar", 2)])
@pytest.mark.parametrize("cap", [1, 7, 25, 1024, 4000])
def test_cell_points_with_empty_cells_match_plain(cuda, kind, dim, cap):
    for R in (1, 3, 1001):
        rows, scale = cell_rows(R, cap, dim, kind, seed=cap + R, device=cuda)
        kw = dict(kind=kind, scale=scale, capacity=cap, dim=dim)
        pa, ma = G.cell_points(*rows, **kw)
        pb, mb = cell_points_ref(*rows, **kw)
        assert torch.equal(pa, pb) and torch.equal(ma, mb), (kind, dim, cap, R)
        assert not pa[~ma].any()


def test_geometric_kernels_refuse_wrong_arguments(cuda):
    plan = GEOM_SPECS[0].plan(1)
    rows = _plan_rows(plan, cuda)
    kw = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
    with pytest.raises(ValueError):
        G.pair_edges(*([rows[0].to(torch.int64)] + rows[1:]), **kw)
    with pytest.raises(ValueError):
        G.pair_edges(*rows, capacity=plan.capacity, dim=4, kinds=plan.kinds_present)
    one = pair_rows(1, 4, 2, seed=1, device=cuda)   # a row too wide for shared memory
    with pytest.raises(RuntimeError):
        G.pair_edges(*one, capacity=3631, dim=plan.dim, kinds=(GEOM_HYP,))
    with pytest.raises(RuntimeError):
        G.pair_edges(*one, capacity=7262, dim=plan.dim, kinds=(GEOM_TORUS,))
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


def _pool_rows(dim):
    """Padded rows of every kind: random (some padded, one empty, one with
    repeated points), exact in-sphere ties, a cavity overflow."""
    pts, cnt = _dt_rows(dim, 90 + dim, B=6, N=160)
    rows = [p[:c].numpy() for p, c in zip(pts, cnt)]
    rows += list(tie_rows(dim, 3, 40 + dim)) + [overflow_row(dim, 60 + dim)]
    N = max(len(r) for r in rows)
    out = np.zeros((len(rows), N, dim))
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, np.array([len(r) for r in rows])


@pytest.mark.parametrize("B", [1, 16, 32, 64, 256])
@pytest.mark.parametrize("dim", [2, 3])
def test_triangulate_clusters_match_plain(cuda, dim, B):
    """B drives the cluster size (16, 8, 4, 2, 1 CTAs a row on an H100);
    every row equals the plain version's: ok, and simp, alive and the
    work counts on the ok rows."""
    pool, pool_cnt = _pool_rows(dim)
    idx = np.arange(B) % len(pool)
    pts, cnt = torch.from_numpy(pool[idx]), torch.from_numpy(pool_cnt[idx])
    N = pts.shape[1]
    kw = dict(dim=dim, num_simplices=D.simplex_capacity(N, dim),
              cavity=D.cavity_capacity(dim), group=D.group_size(dim))
    wk = torch.zeros((B, 2), dtype=torch.int64, device=cuda)
    parts = torch.zeros((B, len(D.TRIP_PARTS)), dtype=torch.int64, device=cuda)
    ks, ka, ko = (t.cpu() for t in D.triangulate(pts.to(cuda), cnt.to(cuda), work=wk,
                                                 parts=parts, **kw))
    wp = torch.zeros((B, 2), dtype=torch.int64)
    ps, pa, po = triangulate_ref(pts, cnt, work=wp, **kw)
    assert torch.equal(ko, po)
    assert torch.equal(ks[po], ps[po]) and torch.equal(ka[po], pa[po])
    assert torch.equal(wk.cpu()[po], wp[po])
    # the tie rows and the overflow row are never ok, the random rows are
    bad = torch.from_numpy((idx >= 6) | (idx == 2))
    assert not bool(ko[bad].any()) and bool(ko[~bad].all())
    busy = wk.cpu()[:, 0] > 0
    assert bool((parts.cpu()[busy] >= 0).all()) and bool((parts.cpu()[busy].sum(1) > 0).all())


def test_triangulate_cluster_sizes(cuda):
    """C comes from B and the card: more than one CTA a row for the main
    path's batches (16 2-D rows, the second round's single row), one for a
    batch the card cannot hold in clusters."""
    sizes = [D.cluster_size(B, 69_888, 2, cuda) for B in (1, 16, 32, 64, 256, 1024)]
    assert sizes[0] > 1 and sizes[1] > 1 and sizes[-1] == 1
    assert all(a >= b for a, b in zip(sizes, sizes[1:]))
    assert set(sizes) <= {1, 2, 4, 8, 16}
    with pytest.raises(RuntimeError):
        D.cluster_size(1, 1 << 24, 2, cuda)                  # its bitmap does not fit


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


@pytest.mark.parametrize("log_n", [1, 26, 40])
@pytest.mark.parametrize("R,cap", [(1, 1), (37, 300), (200, 4096)], ids=str)
def test_chunk_rmat_mixed_rows_match_plain(cuda, log_n, R, cap):
    key, kind, params, fparams, count, owned = chunk_rows(R, cap, 8, R + log_n, cuda)
    before = build.LAUNCHES["chunk_rmat"]
    got = S.chunk_rmat(key, kind, params, fparams, count, owned, log_n, cap)
    assert build.LAUNCHES["chunk_rmat"] == before + 1
    want = chunk_rmat_ref(key, kind, params, fparams, count, owned, log_n, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    out = (torch.full_like(want[0], -3), torch.ones_like(want[1]))
    ref_out = (out[0].clone(), out[1].clone())
    S.chunk_rmat(key, kind, params, fparams, count, owned, log_n, cap, out=out)
    chunk_rmat_ref(key, kind, params, fparams, count, owned, log_n, cap, out=ref_out)
    assert torch.equal(out[0], ref_out[0]) and torch.equal(out[1], ref_out[1])


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("R,cap", [(1, 1), (37, 300), (200, 4096)], ids=str)
def test_chunk_ba_mixed_rows_match_plain(cuda, d, R, cap):
    key, kind, params, _, count, owned = chunk_rows(R, cap, d, 3 * R + d, cuda)
    steps, ref_steps = (torch.zeros(2, dtype=torch.int64, device=cuda) for _ in range(2))
    before = build.LAUNCHES["chunk_ba"]
    got = S.chunk_ba(key, kind, params, count, owned, cap, steps=steps)
    assert build.LAUNCHES["chunk_ba"] == before + 1
    want = chunk_ba_ref(key, kind, params, count, owned, cap, steps=ref_steps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the steps walked; the steps issued follow the warps' schedule, which
    # the plain version does not model: at least the walked, 32 a trip
    assert int(steps[0]) == int(ref_steps[0]) and int(ref_steps[1]) == 0
    assert int(steps[0]) <= int(steps[1]) and int(steps[1]) % 32 == 0
    assert (int(steps[0]) > 0) == bool((kind == 5).any())        # KIND_BA rows walk chains
    out = (torch.full_like(want[0], -3), torch.ones_like(want[1]))
    ref_out = (out[0].clone(), out[1].clone())
    S.chunk_ba(key, kind, params, count, owned, cap, out=out)
    chunk_ba_ref(key, kind, params, count, owned, cap, out=ref_out)
    assert torch.equal(out[0], ref_out[0]) and torch.equal(out[1], ref_out[1])


def test_chunk_ba_long_chains_match_plain(cuda):
    """d = 1 and edge ids past 2^40 (positions, and so spans, past 2^41):
    the chains and targets equal the plain version's."""
    R, cap = 8, 5000
    rng = np.random.default_rng(41)
    key = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (R, 2)).astype(np.int32)).to(cuda)
    kind = torch.full((R,), 5, dtype=torch.int32, device=cuda)
    params = torch.zeros((R, 3), dtype=torch.int64, device=cuda)
    params[:, 0] = 1
    params[:, 1] = torch.from_numpy(rng.integers(2 ** 40, 2 ** 46, R)).to(cuda)
    count = torch.full((R,), cap, dtype=torch.int64, device=cuda)
    owned = torch.ones(R, dtype=torch.bool, device=cuda)
    steps, ref_steps = (torch.zeros(2, dtype=torch.int64, device=cuda) for _ in range(2))
    got = S.chunk_ba(key, kind, params, count, owned, cap, steps=steps)
    want = chunk_ba_ref(key, kind, params, count, owned, cap, steps=ref_steps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(steps[0]) == int(ref_steps[0]) <= int(steps[1])


@pytest.mark.parametrize("S_,NB,N,batch", [(1, 1, 1000, 0), (5, 1, 4096, 4), (64, 8192, 200000, 0),
                                           (64, 8192, 200000, 32), (1024, 64, 50000, 0),
                                           (3, 40000, 30000, 0), (65, 40, 50000, 8),
                                           (200, 16, 50000, 0), (3000, 8, 50000, 0)], ids=str)
def test_close_wedges_matches_plain(cuda, S_, NB, N, batch):
    """Both mask forms, all-sentinel rows, unions within the filter's 32
    bits a key and unions past its 2^18 bits (64 x 8192, 1024 x 64, 40000
    neighbours), one and many sample lists a key, counters past shared
    memory (3000 samples): the kernel over the union table equals both
    plain versions."""
    edges, mask, nb = wedge_inputs(S_, NB, N, S_ + NB, cuda, batch=batch)
    flat, fmask = edges.reshape(-1, 2), mask.reshape(-1)
    table = W.wedge_table(nb)
    before = build.LAUNCHES["close_wedges"]
    got = W.close_wedges(flat, table, mask=fmask)
    assert build.LAUNCHES["close_wedges"] == before + 1
    want = close_wedges_ref(flat, nb, mask=fmask)
    assert torch.equal(got, want) and torch.equal(got, close_wedges_table_ref(flat, table,
                                                                              mask=fmask))
    for k in (0, N // 3, N):
        assert torch.equal(W.close_wedges(flat, table, count=k),
                           close_wedges_ref(flat, nb, count=k))
    empty = W.wedge_table(torch.full_like(nb, 1 << 62))
    assert not W.close_wedges(flat, empty, mask=fmask).any()


@pytest.mark.parametrize("NB", [40, 2000], ids=["union-1e3", "union-past-filter"])
def test_close_wedges_dense_stripes_match_plain(cuda, NB):
    """Buffers whose valid slots fill whole 512-slot stripes (a warp's
    tile) beside empty ones, every endpoint in the union; with a union of
    about 900 vertices and one of about 15,000, past the filter's 32 bits
    a key."""
    rng = np.random.default_rng(7 + NB)
    _, _, nb = wedge_inputs(64, NB, 1, 3, "cpu")
    table = W.wedge_table(nb.to(cuda))
    assert (32 * table.union > 1 << table.log_f) == (NB == 2000)
    live = nb[nb < 1 << 62].numpy()
    N = 512 * 300
    edges = torch.from_numpy(rng.choice(live, (N, 2))).to(cuda)
    stripe = rng.random(N // 512) < 0.5
    mask = torch.from_numpy(np.repeat(stripe, 512) | (rng.random(N) < 0.01)).to(cuda)
    nb = nb.to(cuda)
    got = W.close_wedges(edges, table, mask=mask)
    assert torch.equal(got, close_wedges_ref(edges, nb, mask=mask)) and int(got.sum()) > 0
    assert torch.equal(W.close_wedges(edges, table, count=N - 77),
                       close_wedges_ref(edges, nb, count=N - 77))


@pytest.mark.parametrize("spec", [api.BA(n=3000, d=4, seed=1),
                                  api.RMAT(log_n=14, m=30000, seed=2),
                                  api.SBM(n=4000, blocks=5, p_in=0.01, p_out=0.001, seed=3)],
                         ids=["BA", "RMAT", "SBM"])
def test_family_generate_and_collect_on_the_card_equal_cpu(cuda, spec):
    for P in (1, 3):
        assert torch.equal(api.generate(spec, P, device=cuda).edges.cpu(),
                           api.generate(spec, P, device="cpu").edges)
    if not spec.directed:
        a = api.collect(spec, 3, metrics=("degree", "clustering"), device=cuda)
        b = api.collect(spec, 3, metrics=("degree", "clustering"), device="cpu")
        for f in ("sample", "degree", "triangles", "wedges", "valid"):
            assert np.array_equal(getattr(a.clustering, f), getattr(b.clustering, f)), f


def _regroup(chunks, P):
    per = [[] for _ in range(P)]
    for c in chunks:
        per[c.pe].append(c.edges().cpu())
    return torch.cat([e for pe in per for e in pe])


@pytest.mark.parametrize("spec", [api.SBM(n=4000, blocks=5, p_in=0.01, p_out=0.001, seed=3),
                                  api.RDG(n=2000, dim=2, seed=17)], ids=["SBM", "RDG"])
def test_overlapped_stream_on_the_card_equals_unsegmented(cuda, spec):
    """Segment-local capacities (SBM) and a planner thread that launches
    the Delaunay kernels (RDG, cold seed) give the unsegmented stream."""
    from repro_torch.core import rdg

    rdg.rdg_structure.cache_clear()
    got = _regroup(api.iter_edge_chunks(spec, 8, device=cuda, overlap=4), 8)
    want = _regroup(api.iter_edge_chunks(spec, 8, device=cuda), 8)
    assert torch.equal(got, want) and len(got)
    assert torch.equal(got, api.generate(spec, 8, device="cpu").edges)


def test_stream_waves_make_no_host_sync(cuda):
    """After the tables are on the card, a wave reads nothing back to the
    host, so the host queues the next wave while the card runs this one."""
    from repro_torch.distrib import runtime

    plan = api.SBM(n=1 << 16, blocks=8, p_in=2.0 ** -9, p_out=2.0 ** -13, seed=3).plan(16)
    it = runtime.stream_waves(plan, device=cuda)
    waves = [next(it)]                  # tables and schedule copied, kernels loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        waves += list(it)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(waves) > 8


def test_validate_on_the_card_equals_cpu(cuda):
    from repro_torch import stats

    for spec, P in ((api.GNP(n=4096, p=16 / 4096, seed=1), 4),
                    (api.RHG(n=4096, avg_deg=8, gamma=2.7, seed=1), 4),
                    (api.BA(n=2048, d=4, seed=7), 2)):
        a, b = stats.validate(spec, P, device=cuda), stats.validate(spec, P, device="cpu")
        assert str(a) == str(b) and a.passed
        for x, y in zip(a.checks, b.checks):
            assert (x.name, x.passed, x.observed, x.expected, x.pvalue) == \
                (y.name, y.passed, y.observed, y.expected, y.pvalue)


# ------------------------------------------------------------------ serving

@pytest.mark.parametrize("spec", [api.GNM(n=3000, m=2_500_000, seed=1),
                                  api.SBM(n=4000, blocks=2, p_in=0.6, p_out=0.3, seed=3),
                                  api.GNP(n=1 << 14, p=0.01, seed=2)],
                         ids=["GNM-dense", "SBM-dense", "GNP"])
def test_slab_at_class_capacity_equals_generate(cuda, spec):
    """A served request runs its chunk rows at the power-of-two class
    above the plan's capacity, so ``chunk_sample`` sorts each row in
    another bucket layout; dense rows take redraw rounds.  The delivered
    edges equal ``generate``'s on the card."""
    from repro_torch.serve import Service, program_of

    plan = spec.plan(4)
    assert program_of(plan).capacity > plan.capacity
    before = build.LAUNCHES["chunk_sample"]
    svc = Service(4, device=cuda, slab_batch=3)
    g = svc.submit(spec).result()
    s = svc.submit(spec, sink="stats").result()
    assert build.LAUNCHES["chunk_sample"] > before
    want = api.generate(spec, 4, device=cuda)
    assert torch.equal(g.edges, want.edges) and g.edges.device.type == "cuda"
    assert s["num_edges"] == want.m and torch.equal(s["degrees"], want.degrees())
    assert svc.syncs <= svc.stats["slabs"]


def staged_rows(counts: dict, R: int, device):
    """``R`` rows of each kind in ``counts`` (kind -> the largest count of
    its rows, which row 0 of the kind holds), concatenated: the rows of a
    pair slab and the ``stage`` its scheduler passes."""
    parts = [pair_rows(R, n, 2, seed=3000, device=device, kinds=(k,))
             for k, n in counts.items()]
    rows = [torch.cat([p[t][:, :1] if t in (5, 6) else p[t] for p in parts])
            for t in range(12)]
    rows[-1][:] = True
    return rows


@pytest.mark.parametrize("counts,cap", [({GEOM_HYP: 2500}, 4096),
                                        ({GEOM_HYP: 3630}, 4096),
                                        ({GEOM_TORUS: 5000}, 8192),
                                        ({GEOM_HYP: 300, GEOM_TORUS: 300}, 512),
                                        ({GEOM_HYP: 3000, GEOM_TORUS: 4096}, 4096)],
                         ids=["hyp-2500", "hyp-3630", "torus-5000", "mixed-300",
                              "mixed-3000-4096"])
def test_pair_edges_staged_by_counts_at_class_capacity(cuda, counts, cap):
    """A pair slab runs its rows at the class capacity ``cap`` and stages
    each kind's largest count a side: the kernel equals its plain version
    at that capacity, and the kept edges, in order, equal the rows run at
    their own capacity (the largest count).  A TORUS row of 4096 points
    beside HYP rows of 3000 fits (each kind stages its own bound).  Without ``stage`` the
    class capacity outgrows shared memory; a bound past the capacity is
    refused."""
    R = 2 if cap > 1024 else 19
    rows = staged_rows(counts, R, cuda)
    kinds = tuple(counts)
    ea, ka = G.pair_edges(*rows, capacity=cap, dim=2, kinds=kinds, stage=counts)
    eb, kb = pair_edges_ref(*rows, capacity=cap, dim=2, kinds=kinds, stage=counts)
    assert torch.equal(ea, eb) and torch.equal(ka, kb)
    own = max(counts.values())
    ec, kc = G.pair_edges(*rows, capacity=own, dim=2, kinds=kinds, stage=counts)
    for r in range(len(rows[0])):
        assert torch.equal(ea[r][ka[r]], ec[r][kc[r]]), r
    assert int(ka.sum()) == int(kc.sum()) > 0
    if cap * (32 if GEOM_HYP in kinds else 16) * 2 > 232448:
        with pytest.raises(RuntimeError):
            G.pair_edges(*rows, capacity=cap, dim=2, kinds=kinds)
    with pytest.raises(ValueError):
        G.pair_edges(*rows, capacity=cap, dim=2, kinds=kinds, stage={kinds[0]: cap + 1})


def test_pair_edges_refuses_a_count_past_its_stage(cuda):
    """A HYP row of 300 points under a stage of 299 fails the launch with
    the kernel's device assertion (never a clamped row).  The assertion
    ends the process's CUDA context, so a child process makes the call."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import torch, sys\n"
            "sys.path[:0] = ['src', 'tests']\n"
            "from test_torch_cuda import staged_rows\n"
            "from repro_torch.kernels.geom import ops as G\n"
            "from repro_torch.kernels.geom.ref import GEOM_HYP\n"
            "rows = staged_rows({GEOM_HYP: 300}, 3, torch.device('cuda'))\n"
            "G.pair_edges(*rows, capacity=512, dim=2, kinds=(GEOM_HYP,), stage={GEOM_HYP: 299})\n"
            "torch.cuda.synchronize()\n"
            "print('no error')\n")
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode != 0 and "no error" not in run.stdout, run.stdout
    assert "device-side assert" in run.stderr or "Assertion" in run.stderr, run.stderr[-2000:]


def test_served_pair_plan_past_the_old_staging_limit(cuda):
    """An RGG plan whose capacity (4097..7261) has class 8192, past what
    pair_edges staged by capacity; served, it equals generate."""
    from repro_torch.serve import Service, program_of

    spec = api.RGG(n=20000, radius=0.45, seed=5, chunks=1)
    plan = spec.plan(1)
    assert 4096 < plan.capacity <= 7261 and program_of(plan).capacity == 8192
    got = Service(1, device=cuda, slab_batch=2).submit(spec, sink="stats").result()
    want = api.generate(spec, 1, device=cuda)
    assert got["num_edges"] == want.m and torch.equal(got["degrees"], want.degrees())


def test_serve_fault_reissue_and_overlap_on_the_card(cuda):
    from repro_torch.serve import Service

    spec = api.GNM(n=1 << 14, m=1 << 20, seed=4)
    svc = Service(16, D=4, device=cuda, slab_batch=4)
    t = svc.submit(spec)
    svc.inject_fault([1, 2], at_slab=1)
    svc.drain()
    assert svc.scheduler.reissued > 0
    assert torch.equal(t.result().edges, api.generate(spec, 16, device=cuda).edges)
    sbm = api.SBM(n=4000, blocks=5, p_in=0.01, p_out=0.001, seed=3)
    got = list(Service(8, device=cuda).submit(sbm, sink="chunks", overlap=4).chunks())
    want = list(api.iter_edge_chunks(sbm, 8, device=cuda))
    assert [c.pe for c in got] == [c.pe for c in want]
    assert all(torch.equal(a.edges(), b.edges()) for a, b in zip(got, want))


# ------------------------------------------------------------ the LM stack

def _hyp_inputs(dev, Q, C, rows, seed=0, r_hi=12.0):
    """float64 feature rows ``[Q, 4]``, ``[C, 4]`` of random points, gids
    with repeats across the sides (some self-pairs), and the table."""
    from repro_torch.kernels.hypdist.ops import precompute_features

    rng = np.random.default_rng(seed)
    f = precompute_features(rng.uniform(0.2, r_hi, Q + C), rng.uniform(0, 2 * np.pi, Q + C))
    f = torch.from_numpy(np.ascontiguousarray(f[:, :4])).to(dev)
    gid = torch.from_numpy(rng.integers(0, (Q + C) // 2 + 1, Q + C)).to(dev)
    seg = torch.tensor(rows, dtype=torch.int64).reshape(-1, 4).to(dev)
    return f[:Q], f[Q:], gid[:Q], gid[Q:], seg


def _random_table(rng, Q, C, S):
    rows = []
    for _ in range(S):
        qo, co = int(rng.integers(0, Q + 1)), int(rng.integers(0, C + 1))
        rows.append((qo, int(rng.integers(0, min(Q - qo, 600) + 1)), co,
                     int(rng.integers(0, min(C - co, 3000) + 1))))
    return rows


# (Q, C, segments, seed): one pair, tables with empty segments and rows off
# every multiple of 32, and tables of hundreds of segments (spans of a warp
# crossing many rows and segments)
HYP_SHAPES = [(1, 1, 1, 0), (37, 95, 5, 1), (700, 2900, 40, 2), (4000, 9000, 300, 3),
              (5000, 20000, 17, 4)]


@pytest.mark.parametrize("Q,C,S,seed", HYP_SHAPES, ids=str)
def test_hyp_edges_matches_plain(cuda, Q, C, S, seed):
    from repro_torch.kernels.pairmask.ref import hyp_edges_ref

    rows = _random_table(np.random.default_rng(seed), Q, C, S)
    rows[0] = (0, min(Q, 700), 0, min(C, 3000))
    args = _hyp_inputs(cuda, Q, C, rows, seed)
    for cosh_r in (np.cosh(9.0), np.cosh(13.0), np.cosh(60.0)):
        before = build.LAUNCHES["hyp_edges"]
        got = M.hyp_edges(*args, cosh_r)
        assert build.LAUNCHES["hyp_edges"] == before + 1
        want = hyp_edges_ref(*[a.cpu() for a in args], cosh_r)
        assert torch.equal(got.cpu(), want)
        out = torch.full_like(got, -1)
        M.hyp_edges_into(*args, cosh_r, out)
        assert torch.equal(out, got)
        assert build.LAUNCHES["hyp_edges"] == before + 2


def test_hyp_edges_empty_and_out_of_range_tables(cuda):
    args = list(_hyp_inputs(cuda, 50, 60, [(0, 50, 0, 60)]))
    assert len(M.hyp_edges(*args, np.cosh(60.0))) == 50 * 60 - int(
        (args[2][:, None] == args[3][None, :]).sum())
    args[4] = torch.zeros((0, 4), dtype=torch.int64, device=cuda)
    assert M.hyp_edges(*args, 2.0).shape == (0, 2)
    args[4] = torch.tensor([[0, 0, 0, 0], [0, 50, 0, 60], [3, 48, 0, 1]], device=cuda)
    before = build.LAUNCHES["hyp_edges"]
    with pytest.raises(ValueError, match="segment 2 .* out of range"):
        M.hyp_edges(*args, 2.0)
    assert build.LAUNCHES["hyp_edges"] == before
    # a feature view starting 8 bytes into its storage
    args[4] = torch.tensor([[0, 50, 0, 60]], device=cuda)
    args[1] = torch.cat([torch.zeros(1, dtype=torch.float64, device=cuda),
                         args[1].reshape(-1)])[1:].view(60, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        M.hyp_edges(*args, 2.0)


def test_rhg_pe_pair_mask_launches_match_plain(cuda, monkeypatch):
    """``rhg_pe`` on the card (the data pipeline's graph): one
    ``hyp_edges`` launch a call and no ``pair_mask`` launch; each launch,
    on ``rhg_pe``'s own table, equals the plain version, and the edges
    equal the CPU's, at P = 1 and on a shard of P = 4."""
    from repro_torch.core import rhg
    from repro_torch.kernels.pairmask.ref import hyp_edges_ref

    real, seen = rhg.hyp_edges, []

    def held(*args):
        out = real(*args)
        assert torch.equal(out.cpu(), hyp_edges_ref(*[a.cpu() if torch.is_tensor(a) else a
                                                      for a in args]))
        seen.append(len(args[4]))
        return out

    monkeypatch.setattr(rhg, "hyp_edges", held)
    params = rhg.RHGParams(4096, 16.0, 2.6, 11)
    for P, pe in ((1, 0), (4, 1)):
        seen.clear()
        before = dict(build.LAUNCHES)
        got = rhg.rhg_pe(params, P, pe, device=cuda)
        assert build.LAUNCHES["hyp_edges"] - before["hyp_edges"] == len(seen) == 1
        assert build.LAUNCHES["pair_mask"] == before["pair_mask"]
        assert seen[0] > 10
        want = rhg.rhg_pe(params, P, pe, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_pipeline_batches_on_the_card_equal_cpu(cuda):
    from repro_torch.data import pipeline

    for kind in ("rhg_walk", "er_walk"):
        cfg = pipeline.DataConfig(kind=kind, n_vertices=4096, seq_len=128, num_shards=2, seed=4)
        a = pipeline.make_global_batch(cfg, 1, device=cuda)
        b = pipeline.make_global_batch(cfg, 1, device="cpu")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "mixtral_8x7b", "deepseek_v2_lite_16b",
                                  "jamba_v0_1_52b", "gemma3_27b"])
def test_smoke_models_on_the_card_match_cpu(cuda, arch):
    """float32 on the card against the CPU on the same weights: logits
    within 1e-4 x max |logit| (cuBLAS and ATen's CPU matmuls sum in
    different orders; TF32 is off), the loss within 1e-4, and the first
    greedy token equal (its top-2 gap on the CPU is asserted to exceed
    1e-3 x max |logit|)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.train import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = T.model_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "positions": torch.arange(24).repeat(2, 1),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    with torch.no_grad():
        h, _, _ = T.forward(cpu, cfg, batch)
        hc, _, _ = T.forward(card, cfg, {k: v.to(cuda) for k, v in batch.items()})
        loss = float(T.lm_loss(cpu, cfg, batch)[0])
        loss_c = float(T.lm_loss(card, cfg, {k: v.to(cuda) for k, v in batch.items()})[0])
    scale = float(h.abs().max())
    assert float((hc.cpu() - h).abs().max()) <= 1e-4 * scale
    assert abs(loss - loss_c) <= 1e-4
    with torch.no_grad():
        caches, first = serve.prefill(cpu, cfg, torch.from_numpy(toks[:, :8]), 8)
    top = torch.topk(first, 2, dim=-1).values
    assert float((top[:, 0] - top[:, 1]).min()) > 1e-3 * float(first.abs().max())
    np.testing.assert_array_equal(serve.generate(card, cfg, toks[:, :8], 1),
                                  serve.generate(cpu, cfg, toks[:, :8], 1))



@pytest.mark.parametrize("arch", ["qwen3_0p6b", "deepseek_v2_lite_16b", "jamba_v0_1_52b",
                                  "gemma3_27b", "hubert_xlarge"])
def test_smoke_train_steps_on_the_card_match_cpu(cuda, arch):
    """``make_train_step`` in float32 on the card against the CPU from the
    same weights: a step with ``accum=1``, then one with ``accum=2``, each
    held by the CPU tests' tolerances (``tests/torch_train_tol.py``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    from torch_train_tol import step_errors

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = T.model_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    states = {"cpu": (cpu, O.opt_init(cpu)), "card": (card, O.opt_init(card))}
    rng = np.random.default_rng(0)
    opt_cfg = O.OptConfig(lr=1e-3, warmup=5, total_steps=200)
    for accum in (1, 2):
        toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        batch = {"positions": np.tile(np.arange(32, dtype=np.int32), (4, 1)),
                 "labels": np.roll(toks, -1, axis=1)}
        if cfg.frontend != "none":
            batch["embeds"] = (rng.standard_normal((4, 32, cfg.d_model)) * 0.02).astype(np.float32)
        else:
            batch["tokens"] = toks
        step = make_train_step(cfg, opt_cfg, accum=accum)
        out = {k: step(p, o, batch) for k, (p, o) in states.items()}
        states = {k: v[:2] for k, v in out.items()}
        (pc, oc, mc), (pg, og, mg) = out["cpu"], out["card"]
        assert int(og["step"]) == accum
        step_errors(dict(pg.named_parameters()), og["m"], mg,
                    dict(pc.named_parameters()), oc["m"], mc)


def test_generator_cell_on_the_card(cuda):
    """The dry run's generator cell: PE 0's program of a GNM plan on the
    card under the op scan, no collective, its plan's edges."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_generator_cell(False, n=1 << 20, m=1 << 24, chips=16, device=cuda)
    assert rec["zero_collectives"] and rec["device"] == "cuda"
    assert rec["edges_pe0"] == rec["edges_pe0_plan"] > 0
    assert rec["launches"]["chunk_sample"] >= 1 and rec["launches"]["chunk_decode"] >= 1


def test_dryrun_matmul_flops_equal_the_card_step(cuda):
    """The (1, 1) dry run of qwen3's smoke train step counts the matmul
    flops that ``FlopCounterMode`` counts of that step on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    cfg = get_smoke_config("qwen3_0p6b")
    spec = ShapeSpec("train_smoke", "train", 64, 4)
    try:
        mesh.reset()
        _, _, cost = dryrun.run_step("qwen3_0p6b", spec, mesh.make_debug_mesh(1, 1), cfg=cfg)
    finally:
        mesh.reset()
    params = T.model_init(cfg, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32),
             "positions": np.tile(np.arange(64, dtype=np.int32), (4, 1))}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, O.OptConfig())(params, O.opt_init(params), batch)
    assert cost.flops_by["matmul"] == fc.get_total_flops() > 0


def test_world_of_two_ranks_on_the_card_equals_one_process(cuda, tmp_path):
    """Two spawned ranks of a world, both on the one card, each generating
    its own PEs with no process group: their edges concatenated in rank
    order equal the one-process run on the card (GNM, SBM on its native
    segments, RHG's pair program)."""
    import torch_world_worker as WW

    out = str(tmp_path / "rank")
    torch.multiprocessing.start_processes(WW.run_on_card, args=(2, out), nprocs=2,
                                          start_method="spawn")
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    for name in ("gnm", "sbm", "rhg"):
        cls, kw = WW.SPECS[name]
        want = api.generate(getattr(api, cls)(**kw), WW.P, device=cuda).edges.cpu().numpy()
        np.testing.assert_array_equal(np.concatenate([r[name] for r in ranks]), want)


# --------------------------------------------------------------------------
# one process over several local devices (LocalMesh)
# --------------------------------------------------------------------------

LOCAL_SPECS = [api.GNM(n=3000, m=40_000, seed=1),
               api.SBM(n=4000, blocks=5, p_in=0.01, p_out=0.001, seed=3),
               api.RHG(n=3000, avg_deg=8, gamma=2.8, seed=5)]


def _local_mesh_equals_one_device(mesh, one):
    """Every check of a local mesh against the one-device run on ``one``:
    ``generate`` (the edges gathered on the mesh's first device), the
    stream with and without overlap (each chunk on the device of the row
    that streams its PE, ``runtime.stream_row``; the integer row count's
    chunks in its order) and a fleet with the last row
    dead at slab 1 (every ticket == ``generate``)."""
    from repro_torch.distrib.runtime import stream_row
    from repro_torch.serve import Service

    D, P = mesh.size, 8
    for spec in LOCAL_SPECS:
        want = api.generate(spec, P, device=one).edges
        got = api.generate(spec, P, mesh=mesh, check=True).edges
        assert got.device == mesh.devices[0] and torch.equal(got.cpu(), want.cpu()), spec
        for overlap in (0, 2):
            same = list(api.iter_edge_chunks(spec, P, mesh=D, device=one, batch=4,
                                             overlap=overlap))
            chunks = list(api.iter_edge_chunks(spec, P, mesh=mesh, batch=4, overlap=overlap))
            assert [c.pe for c in chunks] == [c.pe for c in same]
            for c, s in zip(chunks, same):
                assert c.buffer.device == mesh.devices[stream_row(P, D, c.pe, overlap)]
                assert torch.equal(c.edges().cpu(), s.edges().cpu())
    svc = Service(P, mesh=mesh, slab_batch=2)
    tickets = [svc.submit(s) for s in LOCAL_SPECS]
    svc.inject_fault([D - 1], at_slab=1)
    svc.drain()
    assert svc.scheduler.reissued > 0
    for t, spec in zip(tickets, LOCAL_SPECS):
        assert torch.equal(t.result().edges.cpu(),
                           api.generate(spec, P, device=one).edges.cpu()), spec


def test_local_mesh_of_four_rows_on_one_card_equals_one_device(cuda):
    """Four rows on the one card, each on a stream of its own."""
    from repro_torch.distrib.world import LocalMesh

    mesh = LocalMesh([cuda] * 4)
    assert len({mesh.stream(d) for d in range(4)}) == 4
    _local_mesh_equals_one_device(mesh, cuda)
    torch.cuda.synchronize()


def test_local_mesh_on_distinct_cards_equals_one_device(cuda):
    """``mesh_for(8)``'s distinct cards, each row on its card's current
    stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a mesh of distinct cards")
    from repro_torch.distrib import runtime

    mesh = runtime.mesh_for(8)
    assert mesh.size >= 2 and len(set(mesh.devices)) == mesh.size
    _local_mesh_equals_one_device(mesh, cuda)


def test_collect_on_four_rows_of_one_card_equals_one_device(cuda):
    """``collect`` (degrees, in-degrees and sampled clustering) and
    ``validate`` on four rows of the one card, each row's chunks counted
    into the card's accumulators as they arrive from the row's stream,
    equal the one-device reports field by field."""
    from repro_torch import stats
    from repro_torch.distrib.world import LocalMesh

    mesh = LocalMesh([cuda] * 4)
    cases = [(api.GNM(n=3000, m=40_000, seed=1), ("degree", "clustering")),
             (api.GNM(n=3000, m=40_000, directed=True, seed=2), ("degree",)),
             (api.RHG(n=3000, avg_deg=8, gamma=2.8, seed=5), ("degree", "clustering"))]
    for spec, metrics in cases:
        for mode in ("exact", "binned"):
            got = stats.collect(spec, 16, metrics=metrics, mode=mode, mesh=mesh, batch=64)
            want = stats.collect(spec, 16, metrics=metrics, mode=mode, device=cuda, batch=64)
            assert got.num_edges == want.num_edges, spec
            for side in ("degree", "in_degree"):
                a, b = getattr(got, side), getattr(want, side)
                if b is None:
                    assert a is None
                    continue
                assert a.log2_hist.device == cuda and torch.equal(a.log2_hist, b.log2_hist)
                assert (a.deg_sum, a.deg_sumsq, a.deg_max, a.num_isolated) == (
                    b.deg_sum, b.deg_sumsq, b.deg_max, b.num_isolated), spec
                assert (a.degrees is None and b.degrees is None) or torch.equal(a.degrees,
                                                                                b.degrees)
            if want.clustering is not None:
                for f in ("sample", "degree", "triangles", "wedges", "valid"):
                    assert np.array_equal(getattr(got.clustering, f),
                                          getattr(want.clustering, f)), (spec, f)
    spec = api.GNP(n=4096, p=16 / 4096, seed=3)
    assert str(stats.validate(spec, 16, mesh=mesh)) == str(stats.validate(spec, 16, device=cuda))
    torch.cuda.synchronize()


def test_rank_of_two_rows_on_one_card_equals_one_process(cuda, tmp_path):
    """Two ranks of two rows each, all on ``cuda:0``: the ranks' edges of
    GNM, SBM and RHG concatenate to one process's, and their SBM streams
    regroup to its stream by PE."""
    import torch_world_cards_worker as WC

    out = str(tmp_path / "rank")
    torch.multiprocessing.start_processes(WC.run_on_card, args=(2, out), nprocs=2,
                                          start_method="spawn")
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    for name in ("gnm", "sbm", "rhg"):
        cls, kw = WC.SPECS[name]
        want = api.generate(getattr(api, cls)(**kw), WC.P, device=cuda).edges.cpu().numpy()
        np.testing.assert_array_equal(np.concatenate([r[name] for r in ranks]), want)
    cls, kw = WC.SPECS["sbm"]
    one: dict = {}
    for c in api.iter_edge_chunks(getattr(api, cls)(**kw), WC.P, device=cuda):
        one.setdefault(c.pe, []).append(c.edges().cpu())
    got = {pe: e for r in ranks for pe, e in r["sbm_stream"].items()}
    assert sorted(got) == sorted(one)
    for pe, es in one.items():
        np.testing.assert_array_equal(got[pe], torch.cat(es).numpy())


def test_kernels_launch_on_their_tensors_card(cuda):
    """A kernel given tensors of a card that is not the current one runs
    there (``build.launch`` makes it current for the launch) and equals its
    plain version; the current device is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a tensor off the current card")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    key, uni, cnt = sampler_rows(37, 8193, 45, other)
    got = S.chunk_sample(key, uni, cnt, 8193)
    assert got.device == other and torch.cuda.current_device() == 0
    assert torch.equal(got, sample_rows_ref(key, uni, cnt, 8193))
    vals = torch.randint(0, 5000, (100_000,), device=other)
    assert torch.equal(H.hist_counts(vals, 5000), hist_counts_ref(vals, 5000))
    spec = api.RHG(n=3000, avg_deg=8, gamma=2.8, seed=5)
    assert torch.equal(api.generate(spec, 4, device=other).edges.cpu(),
                       api.generate(spec, 4, device="cpu").edges)
    assert torch.cuda.current_device() == 0
