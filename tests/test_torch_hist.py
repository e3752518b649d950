"""The port's hist entry points against ``repro.kernels.hist``.

Every comparison is exact (``np.array_equal``): counts are integers.  The
port runs its plain PyTorch version on CPU tensors; the reference runs
its Pallas kernel in interpret mode (``hist_counts(..., interpret=True)``)
and its ``ops`` wrappers, which send large ``bincount_ids`` calls to XLA's
scatter.  Inputs come from seeded numpy generators.
"""
import numpy as np
import pytest
import torch

from repro.kernels.hist import hist as jhist
from repro.kernels.hist import ops as jops
from repro_torch.kernels.hist import ops as tops

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _values(seed: int, n: int, hi: int) -> np.ndarray:
    """int64 values in [-8, hi): negatives are padding, values past the
    last bin exercise the clamp / drop rules."""
    return np.random.default_rng(seed).integers(-8, hi, n).astype(np.int64)


@pytest.mark.parametrize("n,num_bins,log2", [
    (1000, 16, False), (5000, 500, False), (3000, 4096, False),
    (2048, jhist.LOG2_BINS, True), (0, 8, False),
])
def test_hist_counts_matches_pallas_interpret(n, num_bins, log2):
    v = _values(n + num_bins, n, 3 * num_bins if not log2 else 1 << 30)
    want = np.asarray(jhist.hist_counts(jops.pad_values(v), num_bins=num_bins,
                                        log2=log2, interpret=True))[:num_bins]
    got = tops.hist_counts(torch.from_numpy(v), num_bins, log2=log2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,num_bins", [(0, 16), (100, 16), (4000, 1000), (3000, 4096)])
def test_degree_histogram_matches_reference(n, num_bins):
    v = _values(n, n, 2 * num_bins)
    want = np.asarray(jops.degree_histogram(v, num_bins))
    np.testing.assert_array_equal(
        tops.degree_histogram(torch.from_numpy(v), num_bins).numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 777, 5000])
def test_log2_histogram_matches_reference(n):
    v = np.abs(_values(n + 1, n, 1 << 31))
    v[: min(n, 8)] = [0, 1, 2, 3, 4, 7, 8, (1 << 31) - 1][: min(n, 8)]
    want = np.asarray(jops.log2_histogram(v))
    np.testing.assert_array_equal(tops.log2_histogram(torch.from_numpy(v)).numpy(), want)


@pytest.mark.parametrize("n,length", [
    (0, 10), (500, 64), (4000, 4096),      # the reference's one-hot kernel path
    (3000, 4097), (6000, 20000),           # the reference's XLA scatter path
])
def test_bincount_ids_matches_reference(n, length):
    """Ids >= length are dropped on both of the reference's paths.  Negative
    ids are dropped by its kernel path but wrap around (``length + id``)
    on its scatter path, so they are held against the reference only
    where it drops them; the port drops them at every length."""
    ids = _values(length + n, n, 2 * length)
    got = tops.bincount_ids(torch.from_numpy(ids), length)
    want = np.asarray(jops.bincount_ids(ids[ids >= 0], length))
    np.testing.assert_array_equal(got.numpy(), want)
    if length <= jops.SCATTER_BINS_LIMIT:
        np.testing.assert_array_equal(got.numpy(), np.asarray(jops.bincount_ids(ids, length)))


def test_bincount_ids_adds_into_out():
    """The degree accumulators add every chunk into one section array."""
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 300, 1000), rng.integers(-3, 320, 700)
    acc = torch.zeros(300, dtype=torch.int64)
    tops.bincount_ids(torch.from_numpy(a), 300, out=acc)
    tops.bincount_ids(torch.from_numpy(b), 300, out=acc)
    want = np.asarray(jops.bincount_ids(a, 300)) + np.asarray(jops.bincount_ids(b, 300))
    np.testing.assert_array_equal(acc.numpy(), want)
    with pytest.raises(ValueError):
        tops.bincount_ids(torch.from_numpy(a), 300, out=torch.zeros(299, dtype=torch.int64))


def test_log2_bins_are_the_references():
    assert tops.LOG2_BINS == jhist.LOG2_BINS
