"""The port's Threefry-2x32 against ``jax.random``, word for word.

Every comparison is exact: the port must draw JAX's bits, so keys,
folded keys and 64-bit counter words are compared as integers.  Inputs
come from seeded numpy generators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as jprng
from repro_torch.core import prng as tprng

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _jax_keys(words: np.ndarray):
    return jax.vmap(jax.random.wrap_key_data)(jnp.asarray(words, jnp.uint32))


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 40 + 3])
def test_device_key_matches_jax(seed):
    for path in [(), (11,), (11, 3), (11, 2 ** 31 - 1, 2 ** 31 + 7, 2 ** 33)]:
        want = _words(jprng.device_key(seed, *path))
        got = tprng.device_key(seed, *path).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{seed} {path}")


def test_fold_in_matches_jax_on_int64_ids():
    """Chunk-id columns are int64 (``er._chunk_key_data``); ids near 2^31
    and 2^32 cover the uint32 reduction."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (256, 2), dtype=np.uint64).astype(np.uint32)
    ids = np.concatenate([rng.integers(0, 2 ** 40, 200),
                          2 ** 31 + np.arange(-28, 28)]).astype(np.int64)
    want = np.asarray(jax.vmap(jax.random.key_data)(
        jax.vmap(jax.random.fold_in)(_jax_keys(words), jnp.asarray(ids))))
    got = tprng.fold_in(words, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold_in_many_matches_jax():
    key = jprng.device_key(99, 11)
    ids = np.arange(0, 3000, 7, dtype=np.int64)
    want = np.asarray(jax.vmap(jax.random.key_data)(
        jprng.fold_in_many(key, jnp.asarray(ids))))
    got = tprng.fold_in_many(tprng.device_key(99, 11), ids).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", [0, 1, 63])
@pytest.mark.parametrize("width", [1, 3])
def test_counter_bits64_matches_jax(t, width):
    """The sampler's round key is ``fold_in(key, t)`` with an int64 loop
    counter; slot ids are uint32 (``prng.counter_bits64``)."""
    rng = np.random.default_rng(t * 10 + width)
    for words in rng.integers(0, 2 ** 32, (4, 2), dtype=np.uint64).astype(np.uint32):
        jkey = jax.random.fold_in(jax.random.wrap_key_data(jnp.asarray(words)),
                                  jnp.int64(t))
        want = np.asarray(jprng.counter_bits64(jkey, 97, width)).view(np.int64)
        got = tprng.counter_bits64(tprng.fold_in(words, t), 97, width).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_bits", [3, 31, 33, 50, 62])
def test_mod_u64_matches_numpy(max_bits):
    rng = np.random.default_rng(max_bits)
    hi = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64)
    lo = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64)
    u = rng.integers(1, 2 ** max_bits, 4000, dtype=np.uint64)
    u[:4] = [1, 2, 2 ** max_bits - 1, 2 ** max_bits]
    want = ((hi << np.uint64(32)) | lo) % u
    got = tprng.mod_u64(*(torch.from_numpy(x.astype(np.int64)) for x in (hi, lo, u)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_only_threefry_is_supported():
    with pytest.raises(ValueError, match="rbg"):
        tprng.device_key(1, 11, impl="rbg")
