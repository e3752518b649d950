"""``repro_torch.launch``: the roofline model against the reference's
formulas, and the analytic costs against the bounds ``PERF.md`` records
for the card (``chip_smoke.py``'s kernels line, NVIDIA H100 80GB HBM3).
"""
import pytest
import torch

from repro.launch import roofline as jroof
from repro_torch.launch import cost, roofline

CASES = [(1e12, 5e11, 0.02), (3e9, 7e10, 0.5), (0.0, 1.0, 1e-9), (5e13, 0.0, 2.0)]


@pytest.mark.parametrize("peaks", [(5.0e10, 2.0e10), (1.0e14, 1.0e12), (67e12, 3.35e12)])
@pytest.mark.parametrize("flops,nbytes,measured", CASES)
def test_roofline_matches_the_reference(peaks, flops, nbytes, measured):
    mine, ref = roofline.Peaks(*peaks), jroof.Peaks(*peaks)
    assert roofline.roofline_seconds(flops, nbytes, mine) == \
        jroof.roofline_seconds(flops, nbytes, ref)
    assert roofline.achieved_fraction(flops, nbytes, measured, mine) == \
        jroof.achieved_fraction(flops, nbytes, measured, ref)
    assert roofline.achieved_fraction(flops, nbytes, 0.0, mine) is None


def test_h100_peaks_and_env_override(monkeypatch):
    h = roofline.H100
    assert (h.bytes_per_s, h.flops_per_s) == (3.35e12, 67e12)
    assert h.ops_per_s("int32") == 132 * 128 * 1.98e9
    assert h.ops_per_s("fp64") == 132 * 64 * 2 * 1.98e9
    assert roofline.THREEFRY_OPS == 72
    assert roofline.default_peaks() is h
    # the reference's peak variables do not move the port's H100 peaks
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("REPRO_PEAK_BW", "1e11")
    assert roofline.default_peaks() is h
    assert roofline.roofline_seconds(67e12, 0.0) == 1.0
    # a Peaks without the typed rates falls back to its float32 rate
    assert roofline.Peaks(2e12, 1e11).ops_per_s("int32") == 2e12


RB = cost.pair_edges_row_bytes
# (what, cost, the bound PERF.md records in ms, digits printed, which term)
RECORDED = [
    ("pair_edges, RHG wave 32,768 x 24^2", cost.pair_edges(32768 * RB(1, 4, 2), 32768, 24),
     "0.097091", 6, "bytes"),
    ("pair_edges, RGG generate 4,406,793 x 24^2",
     cost.pair_edges(4406793 * RB(1, 2, 2), 4406793, 24), "13.015", 3, "bytes"),
    ("pair_edges, the fleet's pair slab 61,680 x 32^2",
     cost.pair_edges(61680 * RB(1, 4, 2), 61680, 32), "0.322982", 6, "bytes"),
    ("chunk_rmat [1, 2^30], log_n 26", cost.chunk_rmat(1, 1 << 30, 26), "64.705516", 6,
     "operations"),
    ("chunk_decode, GNM [136, 2,100,416]", cost.chunk_decode(136, 2100416), "2.131765", 6,
     "bytes"),
    ("chunk_sample, GNM [136, 2,100,416], 2^28 drawn", cost.chunk_sample(136, 2100416, 1 << 28),
     "1.733183", 6, "operations"),
    ("chunk_ba [1, 2^28], 536,733,232 steps", cost.chunk_ba(1, 1 << 28, 536733232), "6.930956",
     6, "operations"),
    ("pair_mask euclid [32768, 128, 8]",
     cost.pair_mask(32768 * 128 * 8, 32768 * 128 * 8, 32768 * 128 * 128), "0.240390", 6,
     "bytes"),
]


@pytest.mark.parametrize("what,c,want,digits,by", RECORDED, ids=[r[0] for r in RECORDED])
def test_cost_reproduces_the_recorded_bounds(what, c, want, digits, by):
    assert f"{c.bound_s() * 1e3:.{digits}f}" == want
    assert c.bound_by() == by


# byte terms whose run's counts (points drawn) PERF.md does not record
BYTE_TERMS = [("chunk_sample, SBM [136, 4,198,656]", cost.chunk_sample(136, 4198656), "1.363623"),
              ("cell_points, RGG point plan 906,304 x 25 x 2",
               cost.cell_points(906304 * 40, 906304, 25, 2), "0.125800"),
              ("cell_points, RHG point plan 131,064 x 31 x 2",
               cost.cell_points(131064 * 56, 131064, 31, 2), "0.022809")]


@pytest.mark.parametrize("what,c,want", BYTE_TERMS, ids=[r[0] for r in BYTE_TERMS])
def test_cost_reproduces_the_recorded_byte_terms(what, c, want):
    assert f"{c.seconds()[0] * 1e3:.6f}" == want


def test_triangulate_and_circumspheres_are_float64():
    t = cost.triangulate(800, 96, scanned=1000, group=4, dim=2)
    assert (t.bytes, t.ops, t.op_kind) == (896, 1000 * 4 * 8, "fp64")
    c = cost.circumspheres(10, 3)
    assert (c.bytes, c.ops, c.op_kind) == (10 * 12 * 8 + 10 * 33, 10 * 180, "fp64")
    assert t.seconds()[1] == t.ops / roofline.H100.fp64_flops_per_s


def test_close_wedges_bounds():
    c = cost.close_wedges(100, 10, 1000, 4, hits_u=3, steps=7)
    assert (c.bytes, c.ops) == (100 + 160 + 1000 + 32, (10 + 3) * 8 + 28)
    old = cost.close_wedges_pr16(0, 10, 4, 7, 2)
    assert (old.bytes, old.ops) == (160 + 4 * 7 * 8 + 32, 2 * 10 * 2 * 4 * 4)


def test_summaries():
    c = cost.chunk_rmat(1, 1 << 20, 20)
    s = roofline.program_summary(c, measured_s=2 * c.bound_s())
    assert s["bound"] == "compute" and s["achieved_fraction"] == pytest.approx(0.5)
    assert s["roofline_s"] == c.bound_s()
    assert roofline.program_summary(c)["achieved_fraction"] is None

    from repro_torch import obs

    with obs.capture() as tr:
        with obs.trace("run/exec", phase="exec"):
            sum(range(1000))
    out = roofline.trace_summary(tr, {"run": c})
    assert out["programs"]["run"]["measured_s"] > 0 and "phases" in out


def test_launch_cost_of_a_traced_program():
    import torch

    from repro_torch import api
    from repro_torch.analyze import opscan
    from repro_torch.distrib import runtime

    plan = api.RMAT(log_n=6, m=128, seed=7).plan(4)
    calls = []
    with opscan.trace(calls=calls):
        runtime.run(plan, "cpu", check=False)
    (name, args, kwargs), = calls
    assert name == "chunk_rmat"
    got = cost.launch_cost(name, args, kwargs)
    R = plan.kind.size
    assert got == cost.chunk_rmat(R, plan.capacity, 6)
    with pytest.raises(KeyError):
        cost.launch_cost("no_such_kernel", (torch.zeros(1),), {})


def test_lm_costs_against_hand_counts():
    """Prefill and decode of qwen3-0.6b's smoke config (4 layers, d 64,
    4 heads of 16, 2 KV heads, d_ff 128, vocab 256) counted by hand."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("qwen3_0p6b")
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    mm = sum(p.numel() for p in T.param_shapes(cfg)["layers"].parameters() if p.dim() >= 2)
    assert cost.lm_matmul_params(cfg) == mm == 4 * per_layer
    B, S = 2, 8
    c = cost.lm_prefill(cfg, B, S)
    # 2 flops a weight a token, the head at the last positions, and per
    # layer Q K^T and P V (2 B S^2 H hd each) halved by the causal mask
    assert c.ops == 2 * mm * B * S + 2 * 64 * 256 * B + 4 * (4 * B * S * S * 4 * 16) // 2
    # bf16 weights (layers and head), the K and V caches, the embeddings
    assert c.bytes == (mm + 64 * 256) * 2 + 4 * 2 * B * S * 2 * 16 * 2 + B * S * 64 * 2
    assert c.op_kind == "bf16"
    assert c.seconds()[1] == c.ops / 989e12 == c.ops / roofline.H100.ops_per_s("bf16")
    T_ctx = 12
    d = cost.lm_decode(cfg, B, T_ctx)
    assert d.ops == B * (2 * mm + 2 * 64 * 256 + 4 * 4 * T_ctx * 4 * 16)
    assert d.bytes == (mm + 64 * 256) * 2 + 4 * 2 * B * T_ctx * 2 * 16 * 2
    assert d.bound_by() == "bytes"
    # Qwen3-0.6B at full width: the layers' weights are its parameters less
    # the embedding table, the head and the norm scales
    from repro_torch.configs import get_config

    full = get_config("qwen3_0p6b")
    assert cost.lm_matmul_params(full) == full.param_count() - 2 * 151936 * 1024 - 2 * 1024 * 28


def test_pair_mask_hyp_cost():
    c = cost.pair_mask_hyp(512 * 8, 2048 * 8, 512 * 2048)
    assert (c.bytes, c.ops, c.op_kind) == ((512 + 2048) * 64 + 512 * 2048, 512 * 2048 * 6,
                                           "fp64")


def test_hyp_edges_cost():
    """Features (32 bytes) and gids (8) of both sides read once, 16 bytes a
    hit written, 6 float64 operations a pair; ``launch_cost`` prices a call
    from its table's pairs, every pair a hit at most."""
    c = cost.hyp_edges(1000, 3000, 2_000_000, 5000)
    assert (c.bytes, c.ops, c.op_kind) == (4000 * 40 + 5000 * 16, 12_000_000, "fp64")
    # the fp64 peak: 132 SMs x 64 FMA units x 2 at 1.98 GHz, 33.45e12/s
    assert c.seconds()[1] == 12_000_000 / (132 * 64 * 2 * 1.98e9)
    assert c.bound_by() == "operations"
    # rhg_pe's graph of the pipeline at P = 1 tests at most 13,746,176
    # pairs: a bound of about 2.5 µs
    assert cost.hyp_edges(0, 0, 13_746_176, 0).bound_s() < 2.5e-6
    q, c_ = torch.zeros(10, 4, dtype=torch.float64), torch.zeros(20, 4, dtype=torch.float64)
    seg = torch.tensor([[0, 10, 0, 20], [2, 3, 5, 0], [4, 6, 1, 7]])
    got = cost.launch_cost("hyp_edges", (q, c_, torch.zeros(10, dtype=torch.int64),
                                         torch.zeros(20, dtype=torch.int64), seg, 2.0), {})
    assert got == cost.hyp_edges(10, 20, 200 + 42, 200 + 42)
