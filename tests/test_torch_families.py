"""BA, R-MAT and SBM in the port against the JAX package, and the 64-bit
``jax.random`` draws and the Gumbel sampler they and the reference use.

Every comparison is exact (``np.array_equal`` or ``==``): the port runs
the plain PyTorch versions of its kernels on the CPU (``device="cpu"``)
and must give the reference's draws, plan tables and edges bit for bit.
Keys, ids and bounds come from seeded numpy generators.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ba as jba
from repro.core import prng as jprng
from repro.core import rmat as jrmat
from repro.core import sampling as jsamp
from repro.distrib import engine as jeng
from repro.distrib import runtime as jrt
from repro_torch import api as tapi
from repro_torch.core import prng as tprng
from repro_torch.core import sampling as tsamp
from repro_torch.core import sbm as tsbm
from repro_torch.distrib import engine as teng
from repro_torch.distrib import runtime as trt
from repro_torch.kernels.geom import libm
from repro_torch.kernels.sampler import ops as tops

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

FIELDS = ("kind", "key_data", "universe", "count", "params", "fparams", "owned")
SPECS = {
    "BA": dict(n=128, d=2, seed=3),
    "RMAT": dict(log_n=9, m=2000, seed=4),
    "SBM": dict(n=300, blocks=6, p_in=0.2, p_out=0.01, seed=5),
}
PES = (1, 3, 8)


def _keys(seed: int, k: int):
    """(JAX keys [k], port key words int64 [k, 2]) of seeded key data."""
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (k, 2), dtype=np.uint64)
    kd = kd.astype(np.uint32)
    return (jax.vmap(jax.random.wrap_key_data)(jnp.asarray(kd)),
            torch.from_numpy(kd.astype(np.int64)))


# ---- the 64-bit draws ------------------------------------------------------

def test_fold_in64_and_split_match_jax():
    jk, tk = _keys(0, 64)
    x = np.random.default_rng(1).integers(0, 2 ** 62, 64)
    x[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 40 + 7]            # limb boundaries
    want = np.asarray(jax.random.key_data(jax.vmap(jprng.fold_in64)(jk, jnp.asarray(x))))
    np.testing.assert_array_equal(tprng.fold_in64(tk, torch.from_numpy(x)).numpy(), want)
    for num in (2, 3):
        want = np.asarray(jax.vmap(lambda k: jax.random.key_data(jax.random.split(k, num)))(jk))
        np.testing.assert_array_equal(tprng.split(tk, num).numpy(), want)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_random_bits64_and_uniform_match_jax(shape):
    jk, tk = _keys(2, 32)
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint64))(jk))
    np.testing.assert_array_equal(tprng.random_bits64(tk, shape).numpy(), bits.view(np.int64))
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float64))(jk))
    np.testing.assert_array_equal(tprng.uniform64(tk, shape).numpy(), u)


@pytest.mark.parametrize("lo,hi", [
    (0, 5), (0, 2 ** 32 - 1), (0, 2 ** 32 + 1), (0, 2 ** 40 + 3), (3, 2 ** 62),
    (10, 3), (7, 7),                                         # maxval <= minval: minval
    (-2 ** 62, 2 ** 62 + 5), (-2 ** 63, 2 ** 63 - 1),        # spans from 2^63 on
], ids=str)
def test_randint64_matches_jax(lo, hi):
    jk, tk = _keys(3, 32)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (4,), lo, hi, jnp.int64))(jk))
    np.testing.assert_array_equal(tprng.randint64(tk, lo, hi, (4,)).numpy(), want)


def test_randint64_with_per_key_bounds_matches_jax():
    """BA's draw: one scalar per key, bounds of every size, ids past 2^31."""
    jk, tk = _keys(4, 256)
    hi = np.random.default_rng(5).integers(1, 2 ** 62, 256)
    hi[:8] = [1, 2, 3, 2 ** 31 + 1, 2 ** 32, 2 ** 32 + 1, 2 ** 33 - 1, 2 ** 61]
    want = np.asarray(jax.vmap(lambda k, m: jax.random.randint(k, (), 0, m, jnp.int64))(
        jk, jnp.asarray(hi)))
    np.testing.assert_array_equal(tprng.randint64(tk, 0, torch.from_numpy(hi)).numpy(), want)


# ---- plan tables -----------------------------------------------------------

@pytest.mark.parametrize("P", PES)
@pytest.mark.parametrize("family", sorted(SPECS))
def test_plan_tables_match_reference(family, P):
    ref = getattr(japi, family)(**SPECS[family]).plan(P)
    port = getattr(tapi, family)(**SPECS[family]).plan(P)
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (port.n, port.capacity, port.kinds_present, port.rmat_log_n) == (
        ref.n, ref.capacity, ref.kinds_present, ref.rmat_log_n)
    re_ref, re_port = ref.reseed(77), port.reseed(77)
    for f in ("key_data", "count"):
        np.testing.assert_array_equal(getattr(re_port, f), getattr(re_ref, f), err_msg=f)
    assert re_port.capacity == re_ref.capacity


def test_sbm_block_of_matches_reference():
    from repro.core import sbm as jsbm

    v = np.random.default_rng(6).integers(0, 1001, 500)
    np.testing.assert_array_equal(tsbm.block_of(1001, 7, v), jsbm.block_of(1001, 7, v))


# ---- the per-kind programs -------------------------------------------------

def _rows(kind, params, count, seed=7):
    R = len(kind)
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (R, 2), dtype=np.uint64)
    kd = kd.astype(np.uint32)
    return (kd, torch.from_numpy(kd.view(np.int32)), torch.tensor(kind, dtype=torch.int32),
            torch.tensor(params, dtype=torch.int64), torch.tensor(count, dtype=torch.int64))


@pytest.mark.parametrize("log_n", [1, 9, 26])
def test_chunk_rmat_ref_matches_rmat_edges(log_n):
    """Rows of other kinds stay (0, 0) and unkept; edge ids past 2^31."""
    cap = 96
    kd, key, kind, params, count = _rows(
        [4, 0, 4, 1], [[log_n, 0, 0], [0, 0, 0], [log_n, 2 ** 33 + 5, 0], [0, 0, 0]],
        [90, 0, 96, 50])
    probs = np.array([[0.57, 0.19, 0.19, 0.05], [0, 0, 0, 0], [0.45, 0.25, 0.15, 0.15],
                      [0, 0, 0, 0]])
    owned = torch.tensor([True, True, False, True])
    edges, keep = tops.chunk_rmat(key, kind, params, torch.from_numpy(probs), count, owned,
                                  log_n, cap)
    for r in (0, 2):
        ids = jnp.asarray(params[r, 1].item() + np.arange(cap), jnp.int64)
        src, dst = jrmat._rmat_edges(jax.random.wrap_key_data(jnp.asarray(kd[r])), ids,
                                     jnp.asarray(probs[r]), log_n)
        np.testing.assert_array_equal(edges[r].numpy(), np.stack([src, dst], axis=1))
        np.testing.assert_array_equal(keep[r].numpy(),
                                      (np.arange(cap) < count[r].item()) & owned[r].item())
    assert not edges[[1, 3]].any() and not keep[[1, 3]].any()


def test_chunk_ba_ref_matches_resolve_targets():
    """Sources ``e // d``, targets of the chains, the step count, and an
    ``out`` whose other rows are left as they are."""
    cap = 64
    kd, key, kind, params, count = _rows(
        [5, 2, 5, 5], [[8, 0, 0], [0, 0, 0], [1, 2 ** 31 + 3, 0], [3, 5000, 0]],
        [64, 10, 40, 0])
    owned = torch.tensor([True, True, True, False])
    out = (torch.full((4, cap, 2), -1, dtype=torch.int64), torch.ones((4, cap), dtype=torch.bool))
    steps = torch.zeros(2, dtype=torch.int64)
    edges, keep = tops.chunk_ba(key, kind, params, count, owned, cap, out=out, steps=steps)
    assert edges is out[0] and keep is out[1]
    for r in (0, 2, 3):
        d, e0 = params[r, 0].item(), params[r, 1].item()
        ids = jnp.asarray(e0 + np.arange(cap), jnp.int64)
        tgt = jba._resolve_targets(jax.random.wrap_key_data(jnp.asarray(kd[r])), ids, d)
        np.testing.assert_array_equal(edges[r].numpy(),
                                      np.stack([np.asarray(ids) // d, tgt], axis=1))
        np.testing.assert_array_equal(keep[r].numpy(),
                                      (np.arange(cap) < count[r].item()) & owned[r].item())
        assert (edges[r, :, 1] <= edges[r, :, 0]).all()
    assert (edges[1] == -1).all() and keep[1].all()
    walked, issued = steps.tolist()
    assert walked >= 3 * cap                               # every chain takes a step
    assert issued == 0        # the issued steps follow the kernel's schedule: not modelled here


def test_mixed_plan_matches_reference_engine():
    """DIRECTED, RMAT, BA and EMPTY rows in one table: each program
    writes its own rows, equal to the reference's vmapped chunk program."""
    ref = japi.GNM(n=3000, m=20000, directed=True, seed=11).plan(2)
    t = {f: getattr(ref, f).copy() for f in FIELDS}
    t["kind"][0, 0], t["params"][0, 0], t["fparams"][0, 0] = jeng.KIND_RMAT, [12, 2 ** 32, 0], [
        0.5, 0.2, 0.2, 0.1]
    t["kind"][1, 0], t["params"][1, 0] = jeng.KIND_BA, [4, 777, 0]
    t["kind"][1, -1] = jeng.KIND_EMPTY
    mixed = jeng.ChunkPlan(**{f: t[f] for f in FIELDS}, n=ref.n, capacity=ref.capacity)
    payload, valid, _ = jrt.run(mixed)
    port = teng.chunk_plan_from_arrays(t, ref.n, ref.capacity)
    assert port.kinds_present == mixed.kinds_present and port.rmat_log_n == 12
    tp, tv = trt.run(port, "cpu")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(tp.numpy()[tv.numpy()], np.asarray(payload)[np.asarray(valid)])


# ---- generate and stream ---------------------------------------------------

@pytest.mark.parametrize("P", PES)
@pytest.mark.parametrize("family", sorted(SPECS))
def test_generate_matches_reference(family, P):
    want = japi.generate(getattr(japi, family)(**SPECS[family]), P).edges
    g = tapi.generate(getattr(tapi, family)(**SPECS[family]), P, device="cpu")
    assert g.directed == (family != "SBM") and g.n == getattr(japi, family)(
        **SPECS[family]).num_vertices
    np.testing.assert_array_equal(g.edges.numpy(), want)


@pytest.mark.parametrize("P", PES)
@pytest.mark.parametrize("family", sorted(SPECS))
def test_iter_edge_chunks_matches_reference(family, P):
    want = japi.generate(getattr(japi, family)(**SPECS[family]), P).edges
    chunks = list(tapi.iter_edge_chunks(getattr(tapi, family)(**SPECS[family]), P,
                                        device="cpu"))
    assert [c.pe for c in chunks] == sorted(c.pe for c in chunks)
    for c in chunks:
        assert c.count == int(c.mask.sum())
    np.testing.assert_array_equal(torch.cat([c.edges() for c in chunks]).numpy(), want)


def test_specs_are_graph_specs():
    for family, kw in SPECS.items():
        assert isinstance(getattr(tapi, family)(**kw), tapi.GraphSpec)
    assert tapi.RMAT(log_n=5, m=10).num_vertices == 32
    assert tapi.RMAT(log_n=5, m=10).probs == japi.RMAT(log_n=5, m=10).probs


# ---- the Gumbel sampler ----------------------------------------------------

def test_glibc_log_any_equals_the_c_library():
    """The Gumbel sampler's ``log`` is glibc's (the reference's fused
    program calls it; its near-1 polynomial included), on 10^6 seeded
    inputs around 1, across the range, and at the branch edges."""
    rng = np.random.default_rng(8)
    lo, hi = 1.0 - 2.0 ** -4, 1.0 + 0x109 / 2 ** 12
    x = np.concatenate([rng.uniform(0.9, 1.1, 600_000),
                        np.exp(rng.uniform(-708.0, 709.0, 400_000)),
                        np.nextafter(lo, [0.0, 2.0]), np.nextafter(hi, [0.0, 2.0]),
                        [lo, hi, 1.0, 1.0 - 2.0 ** -53, 1.0 + 2.0 ** -52, 2.3e-308]])
    want = np.array([math.log(v) for v in x])
    np.testing.assert_array_equal(libm.glibc_log_any(torch.from_numpy(x)).numpy(), want)


def test_gumbel_matches_jitted_jax_gumbel():
    """10^6 draws of one key: -log(-log(u)) with JAX's uniforms."""
    key = jax.random.key(77)
    want = np.asarray(jax.jit(lambda k: jax.random.gumbel(k, (10 ** 6,), jnp.float64))(key))
    got = tsamp.gumbel(np.asarray(jax.random.key_data(key)), 10 ** 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("universe,count,capacity", [
    (2556, 25, 81), (83, 43, 53), (168, 123, 229), (3354, 0, 1), (5, 5, 64), (4096, 512, 512),
], ids=str)
def test_gumbel_sampler_matches_reference(universe, count, capacity):
    kd = np.random.default_rng(universe).integers(0, 2 ** 32, 2, dtype=np.uint64)
    kd = kd.astype(np.uint32)
    want = jsamp.sample_wo_replacement(jax.random.wrap_key_data(jnp.asarray(kd)), universe,
                                       count, capacity, method="gumbel")
    got = tsamp.sample_wo_replacement(kd, universe, count, capacity, method="gumbel")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
