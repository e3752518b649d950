"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device, which
skips when there is none (CUDA kernels have no CPU mode).  Every
comparison is exact (``torch.equal``).  Run on a machine with an H100 and
``nvcc``: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import build
from repro_torch.kernels.hist import ops as H
from repro_torch.kernels.hist.ref import hist_counts_ref
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
