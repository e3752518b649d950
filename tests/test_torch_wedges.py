"""The wedge-closing kernel's union table and its plain version against
``repro.stats.accumulate._close_wedges``.

:func:`wedge_table` builds the union of the sample rows (keys by linear
probing, each key's samples as a list, a bit filter); the table's plain
version :func:`close_wedges_table_ref` probes it edge by edge, as the
kernel does.  Both are held, exactly (integer counts), against the JAX
reference and against ``close_wedges_ref`` (the plain version over the
padded neighbour table), with one and many samples a key, empty and
all-sentinel rows, duplicate slots, self-loops, both mask forms and the
wrapper adding into ``out``.  The port runs on the CPU, where the wrapper
computes the table's plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.stats import accumulate as jacc
from repro_torch.kernels.wedges import ops as wops
from repro_torch.kernels.wedges.ref import close_wedges_ref, close_wedges_table_ref
from repro_torch.kernels.wedges.table import (EMPTY, MUL_FILTER, MUL_SLOT, SENTINEL,
                                              filter_entry, hash_bits, probe, wedge_table)

torch.set_num_threads(1)


def _rows(rng, S: int, NB: int, n: int):
    """``[S, NB]`` sorted rows of random lengths (row 0 full), every third
    one empty (all sentinel), drawn from ``[0, n)``."""
    tbl = np.full((S, NB), SENTINEL, np.int64)
    for s in range(S):
        if s % 3 == 2:
            continue
        k = NB if s == 0 else int(rng.integers(0, NB + 1))
        tbl[s, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return tbl


def _buffer(rng, tbl, N: int, n: int):
    """``[N, 2]`` endpoints, half of them from the rows' union, with
    duplicate slots and self-loops, and a mask keeping about a third."""
    live = tbl[tbl < SENTINEL]
    e = rng.integers(0, n, (N, 2))
    if len(live):
        e = np.where(rng.random((N, 2)) < 0.5, rng.choice(live, (N, 2)), e)
    e[N // 4: N // 4 + 40] = e[:40]              # duplicate slots
    e[N // 2: N // 2 + 40, 1] = e[N // 2: N // 2 + 40, 0]   # self-loops
    return e, rng.random(N) < 0.35


def _jax(e, valid, tbl):
    return np.asarray(jacc._close_wedges(jnp.asarray(e), jnp.asarray(valid), jnp.asarray(tbl)))


@pytest.mark.parametrize("form", ["mask", "prefix"])
@pytest.mark.parametrize("S,NB", [(1, 7), (5, 30), (64, 40), (65, 40), (200, 12)], ids=str)
def test_table_plain_matches_reference(S, NB, form):
    """S of one and several filter/list sizes; a vertex in up to dozens of
    rows (n small against S x NB)."""
    rng = np.random.default_rng(S * 100 + NB)
    n = 3 * NB + 50
    tbl = _rows(rng, S, NB, n)
    e, mask = _buffer(rng, tbl, 3000, n)
    table = wedge_table(torch.from_numpy(tbl))
    edges = torch.from_numpy(e)
    if form == "mask":
        want = _jax(e, mask, tbl)
        kw = {"mask": torch.from_numpy(mask)}
    else:
        k = 2111
        want = _jax(e, np.arange(len(e)) < k, tbl)
        kw = {"count": k}
    got = close_wedges_table_ref(edges, table, **kw)
    assert got.dtype == torch.int64 and got.shape == (S,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  close_wedges_ref(edges, torch.from_numpy(tbl), **kw).numpy())
    assert want.sum() > 0


@pytest.mark.parametrize("S", [1, 64, 65])
def test_no_live_row_counts_nothing(S):
    tbl = np.full((S, 5), SENTINEL, np.int64)
    table = wedge_table(torch.from_numpy(tbl))
    assert table.union == 0 and table.ids.numel() == 0 and (table.hkey == EMPTY).all()
    e = np.random.default_rng(S).integers(0, 50, (400, 2))
    got = wops.close_wedges(torch.from_numpy(e), table)
    np.testing.assert_array_equal(got.numpy(), _jax(e, np.ones(400, bool), tbl))
    assert not got.any()


def test_wrapper_adds_into_out_in_both_forms():
    rng = np.random.default_rng(5)
    tbl = _rows(rng, 65, 20, 80)
    e, mask = _buffer(rng, tbl, 1000, 80)
    table = wops.wedge_table(torch.from_numpy(tbl))
    edges, m = torch.from_numpy(e), torch.from_numpy(mask)
    out = torch.arange(65, dtype=torch.int64)
    assert wops.close_wedges(edges, table, mask=m, out=out) is out
    wops.close_wedges(edges, table, count=600, out=out)
    want = np.arange(65) + _jax(e, mask, tbl) + _jax(e, np.arange(1000) < 600, tbl)
    np.testing.assert_array_equal(out.numpy(), want)
    # mask wins over count, as in the sampler
    np.testing.assert_array_equal(wops.close_wedges(edges, table, mask=m, count=3).numpy(),
                                  _jax(e, mask, tbl))
    with pytest.raises(ValueError, match="out"):
        wops.close_wedges(edges, table, out=torch.zeros(64, dtype=torch.int64))


@pytest.mark.parametrize("S,NB,n", [(3, 9, 40), (64, 300, 1000), (200, 64, 100_000)], ids=str)
def test_table_lists_each_key_under_its_rows(S, NB, n):
    """Every key is found at its slot (after the slots from its home on,
    none empty), its list is the ascending rows holding it, its filter bit
    is set; no other id is found; the build is deterministic."""
    rng = np.random.default_rng(S + NB)
    tbl = _rows(rng, S, NB, n)
    table = wedge_table(torch.from_numpy(tbl))
    T = table.hkey.numel()
    assert T & (T - 1) == 0 and T >= 2 * table.union and table.off.numel() == T + 1
    slots = torch.nonzero(table.hkey != EMPTY).flatten()
    keys = table.hkey[slots]
    np.testing.assert_array_equal(np.sort(keys.numpy()), np.unique(tbl[tbl < SENTINEL]))
    np.testing.assert_array_equal(probe(table, keys).numpy(), slots.numpy())
    home = hash_bits(keys, MUL_SLOT, table.log_t)
    for h, at in zip(home.tolist(), slots.tolist()):
        walk = np.arange(h, h + ((at - h) % T)) % T
        assert (table.hkey[walk] != EMPTY).all()
    for key, at in zip(keys.tolist(), slots.tolist()):
        rows = table.ids[table.off[at]: table.off[at + 1]].numpy()
        np.testing.assert_array_equal(rows, np.nonzero((tbl == key).any(axis=1))[0])
    w, b1, b2 = filter_entry(keys, table.log_f)
    word = table.filt[w].to(torch.int64)
    assert ((word >> b1) & (word >> b2) & 1 == 1).all()
    absent = torch.from_numpy(np.setdiff1d(np.arange(-5, n + 50), keys.numpy()))
    assert (probe(table, absent) == -1).all()
    again = wedge_table(torch.from_numpy(tbl))
    assert all(torch.equal(a, b) for a, b in zip(table[1:], again[1:]))


def test_table_dedupes_and_refuses_negative_ids():
    tbl = np.array([[3, 3, 7, SENTINEL], [7, 9, 9, 9]], np.int64)
    table = wedge_table(torch.from_numpy(tbl))
    assert table.union == 3 and table.ids.numel() == 4
    e = torch.tensor([[3, 7], [9, 7], [7, 7], [3, 3], [9, 3]])
    np.testing.assert_array_equal(close_wedges_table_ref(e, table).numpy(),
                                  _jax(e.numpy(), np.ones(5, bool), tbl))
    with pytest.raises(ValueError, match=">= 0"):
        wedge_table(torch.tensor([[-4, 2]]))


def test_hash_bits_is_the_unsigned_product():
    q = np.random.default_rng(1).integers(-(1 << 62), 1 << 62, 5000)
    for mul in (MUL_SLOT, MUL_FILTER):
        for bits in (4, 13, 31):
            want = (q.astype(np.uint64) * np.uint64(mul)) >> np.uint64(64 - bits)
            np.testing.assert_array_equal(hash_bits(torch.from_numpy(q), mul, bits).numpy(),
                                          want.astype(np.int64))
