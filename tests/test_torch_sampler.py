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
    first = torch.sort(tsamp.chunk_draw(k, uni, cnt, 0, 2048), dim=-1).values
    assert bool((first[0, 1:] == first[0, :-1]).any())
    s = tsamp.sample_rows(k, uni, cnt, 2048)[0]
    assert not bool((s[1:] == s[:-1]).any())


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
    with pytest.raises(NotImplementedError):
        tsamp.sample_wo_replacement(np.zeros(2, np.uint32), 100, 5, 64, method="gumbel")
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
