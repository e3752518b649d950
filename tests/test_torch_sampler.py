"""The port's collision sampler and decodes against ``repro.core.sampling``.

Every comparison is exact (``np.array_equal``): the port runs the plain
PyTorch versions of its kernels on the CPU and must return the
reference's sorted values, masks and edges bit for bit.  Keys and
indices come from seeded numpy generators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsamp
from repro_torch.core import sampling as tsamp
from repro_torch.kernels.sampler.ref import (BUCKET_TARGET, HIST_MAX, barrett_mod64,
                                             buckets_per_row, chunk_draw_ref, row_buckets)

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

# (universe, count, capacity): sparse rows, a dense row (count ~ U/2, so
# several redraw rounds run), a count-0 row and an empty universe
CASES = [
    (2 ** 40, 60, 64),
    (10 ** 6, 1000, 1024),
    (2 ** 50, 4000, 4096),
    (4000, 2000, 2048),
    (1000, 0, 64),
    (0, 0, 64),
]


@pytest.mark.parametrize("universe,count,capacity", CASES)
def test_sample_collision_matches_reference(universe, count, capacity):
    rng = np.random.default_rng(universe % 1000 + count)
    for words in rng.integers(0, 2 ** 32, (2, 2), dtype=np.uint64).astype(np.uint32):
        jv, jm = jsamp._sample_collision(jax.random.wrap_key_data(jnp.asarray(words)),
                                         universe, count, capacity)
        tv, tm = tsamp.sample_wo_replacement(words, universe, count, capacity)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_dense_row_needs_redraw_rounds():
    """The dense case exercises the redraw path: a first round alone
    leaves duplicates."""
    words = np.array([7, 9], np.uint32)
    k = tsamp.key_bits32(words).reshape(1, 2)
    uni, cnt = torch.tensor([4000]), torch.tensor([2000])
    first = torch.sort(chunk_draw_ref(k, uni, cnt, 0, 2048), dim=-1).values
    assert bool((first[0, 1:] == first[0, :-1]).any())
    rounds = torch.zeros(1, dtype=torch.int32)
    s = tsamp.sample_rows(k, uni, cnt, 2048, rounds)[0]
    assert not bool((s[1:] == s[:-1]).any())
    assert int(rounds[0]) >= 3


def test_sample_rows_matches_reference_over_0_1_and_many_rounds():
    """Rows whose first sort leaves no duplicate, one redraw round, and
    at least three, in one batch: each row equals the reference's
    ``_sample_collision`` and the rounds counted are 0, 1 and >= 3."""
    rng = np.random.default_rng(17)
    words = rng.integers(0, 2 ** 32, (8, 2), dtype=np.uint64).astype(np.uint32)
    cap = 2048
    uni = np.array([10 ** 6] * 6 + [4000, 2 ** 40], np.int64)
    cnt = np.array([1500] * 6 + [2000, 5], np.int64)
    rounds = torch.zeros(8, dtype=torch.int32)
    got = tsamp.sample_rows(tsamp.key_bits32(words), torch.from_numpy(uni),
                            torch.from_numpy(cnt), cap, rounds)
    for r in range(8):
        want, _ = jsamp._sample_collision(jax.random.wrap_key_data(jnp.asarray(words[r])),
                                          int(uni[r]), int(cnt[r]), cap)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
    assert rounds[:6].tolist() == [1, 1, 1, 1, 1, 0] and rounds[7] == 0 and rounds[6] >= 3


@pytest.mark.parametrize("capacity", [1, 64, 2048, 2049, 2_100_416, 4_198_656, 16_782_144,
                                      40_000_000])
def test_row_buckets_are_monotone_and_bounded(capacity):
    """The kernel's bucket of a value, ``v >> s``, is monotone over every
    value a row can hold (draws and sentinels, up to ``universe +
    capacity``); a row of n draws has at most ``min(ceil(n / 2048),
    8192)`` buckets (what ``buckets_per_row`` allots: the shared-memory
    counters), and ``s`` is the smallest shift that gives that."""
    rng = np.random.default_rng(capacity)
    universes = [0, 1, 2, 3, 4000, capacity, 3 * capacity // 2 + 1, 2 ** 24, 2 ** 40,
                 2 ** 40 + 12345, 2 ** 62 - 1, *rng.integers(1, 2 ** 62, 6).tolist()]
    for universe in universes:
        for count in {0, 1, min(capacity, 2047), 2049, capacity, capacity + 5, universe}:
            n, m, s, nb = row_buckets(universe, count, capacity)
            assert n == min(max(count, 0), capacity) and m == max(universe, 1)
            assert nb <= buckets_per_row(capacity)
            if n == 0:
                assert nb == 0
                continue
            limit = min(-(-n // BUCKET_TARGET), HIST_MAX)
            assert ((m - 1) >> s) + 1 == nb <= limit
            assert s == 0 or ((m - 1) >> (s - 1)) + 1 > limit
            vals = np.unique(np.concatenate([
                rng.integers(0, universe + capacity + 1, 2000, dtype=np.int64),
                [0, m - 1, m, universe, universe + capacity - 1, universe + capacity]]))
            vals = vals[vals >= 0]
            b = [int(v) >> s for v in vals]
            assert b == sorted(b)
            assert max(int(v) >> s for v in vals[vals < m]) < nb


def test_barrett_mod64_equals_python_remainder():
    """The exact reciprocal reduction (``threefry.cuh``'s mod64/div64, two
    corrections at most) equals ``%`` and ``//`` on spans of 1, 2, past
    2^32 and past 2^63, on seeded and boundary dividends."""
    rng = np.random.default_rng(23)
    spans = [1, 2, 3, 7, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 1, 2 ** 32 + 12345, 2 ** 63 - 1,
             2 ** 63, 2 ** 63 + 1, 2 ** 63 + 987654321, 2 ** 64 - 2, 2 ** 64 - 1]
    spans += [int(x) for x in rng.integers(1, 2 ** 63, 40, dtype=np.int64)]
    spans += [int(x) + 2 ** 63 for x in rng.integers(0, 2 ** 63, 20, dtype=np.int64)]
    for d in spans:
        xs = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2 ** 64 - 1, 2 ** 64 - 1 - d]
        xs += [int(a) * 2 ** 32 + int(b) for a, b in rng.integers(0, 2 ** 32, (200, 2))]
        for x in xs:
            if 0 <= x < 2 ** 64:
                assert barrett_mod64(x, d) == (x % d, x // d), (x, d)


def test_sample_rows_is_per_row():
    """A batch of rows gives each row what it gives alone."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, (5, 2), dtype=np.uint64).astype(np.uint32)
    uni = np.array([2 ** 40, 300, 5000, 0, 999], np.int64)
    cnt = np.array([100, 150, 256, 0, 1], np.int64)
    batch = tsamp.sample_rows(tsamp.key_bits32(words), torch.from_numpy(uni),
                              torch.from_numpy(cnt), 256)
    for r in range(5):
        one, _ = tsamp.sample_wo_replacement(words[r], int(uni[r]), int(cnt[r]), 256)
        np.testing.assert_array_equal(batch[r].numpy(), one.numpy())


def test_gumbel_is_not_ported():
    """The Gumbel sampler is ported now (its parity tests are in
    tests/test_torch_families.py): one row equals the reference's, and
    a count past what it holds or an unknown method raises."""
    kd = np.array([7, 11], np.uint32)
    want = jsamp.sample_wo_replacement(jax.random.wrap_key_data(jnp.asarray(kd)), 100, 5, 64,
                                       method="gumbel")
    got = tsamp.sample_wo_replacement(kd, 100, 5, 64, method="gumbel")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="gumbel"):
        tsamp.sample_wo_replacement(kd, 100, 65, 64, method="gumbel")
    with pytest.raises(ValueError):
        tsamp.sample_wo_replacement(np.zeros(2, np.uint32), 100, 5, 64, method="nope")


def test_decode_tri_matches_reference():
    k = np.arange(-600, 600, dtype=np.int64)
    idx = np.concatenate([np.arange(1 << 20, dtype=np.int64), 2 ** 52 + k,
                          2 ** 62 - 1 - np.abs(k)])
    ju, jv = jsamp.decode_tri(jnp.asarray(idx), 5)
    tu, tv = tsamp.decode_tri(torch.from_numpy(idx), 5)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_directed_and_rect_match_reference():
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 2 ** 40, 20000, dtype=np.int64)
    for n, row_lo in [(2, 0), (1 << 12, 17), (1 << 24, 1 << 20)]:
        ju, jv = jsamp.decode_directed(jnp.asarray(idx), n, row_lo)
        tu, tv = tsamp.decode_directed(torch.from_numpy(idx), n, row_lo)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for width, rlo, clo in [(1, 3, 0), (777, 1000, 10), (1 << 20, 1 << 21, 5)]:
        ju, jv = jsamp.decode_rect(jnp.asarray(idx), width, rlo, clo)
        tu, tv = tsamp.decode_rect(torch.from_numpy(idx), width, rlo, clo)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_round_up_capacity_matches_reference():
    for x in [0, 1, 63, 64, 65, 2100000]:
        assert tsamp.round_up_capacity(x) == jsamp.round_up_capacity(x)
