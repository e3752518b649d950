"""The port's plain transcendental functions (``repro_torch.kernels.geom.libm``)
against what the reference's programs run on the CPU, bit for bit.

XLA-CPU's own ``exp``, ``expm1`` and ``log1p`` are taken from jitted
``jnp`` functions; glibc's ``log``, ``sin`` and ``cos`` from Python's
``math`` module, which calls the same C library.  Each function gets 10^6
inputs made from a seed with numpy over the domain the RHG path gives it,
and the branch and table boundaries of its algorithm, a few ulp to either
side.  The device versions (``csrc/libm.cuh``) must carry the same
constants and tables; the card tests hold their results to these.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (turns on float64 in JAX, as the reference runs)
from repro_torch.kernels.geom import libm
from torch_libm_inputs import INPUTS, N, around

CUH = Path(libm.__file__).with_name("csrc") / "libm.cuh"


def bits_equal(got: np.ndarray, want: np.ndarray, x: np.ndarray) -> None:
    bad = got.view(np.int64) != want.view(np.int64)
    assert not bad.any(), [(float(a).hex(), float(b).hex(), float(c).hex())
                           for a, b, c in zip(x[bad][:5], got[bad][:5], want[bad][:5])]


# the reference of each function: XLA's expansions jitted, glibc's through math
REFERENCE = {"xla_exp": jax.jit(jnp.exp), "xla_expm1": jax.jit(jnp.expm1),
             "xla_log1p": jax.jit(jnp.log1p), "glibc_log": math.log, "glibc_sin": math.sin,
             "glibc_cos": math.cos}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_plain_function_equals_the_reference_bit_for_bit(name):
    ref = REFERENCE[name]
    x = INPUTS[name](np.random.default_rng(sorted(REFERENCE).index(name) + 151))
    assert len(x) >= N
    got = getattr(libm, name)(torch.from_numpy(x)).numpy()
    if name.startswith("xla"):
        want = np.asarray(ref(x))
    else:
        want = np.array([ref(v) for v in x.tolist()])
    bits_equal(got, want, x)


def test_log1p_takes_log_from_sqrt2_minus_1_on():
    """The two sides of XLA's log1p meet at sqrt(2) - 1: just below, the
    rational form; from it on, glibc's log of 1 + x."""
    x = torch.from_numpy(around([libm.LOG1P_SMALL], 8))
    big = x.abs() >= libm.LOG1P_SMALL
    np.testing.assert_array_equal(libm.xla_log1p(x)[big].numpy(),
                                  libm.glibc_log(x[big] + 1.0).numpy())
    assert bool(big.any()) and bool((~big).any())


def test_functions_keep_shape_and_device():
    x = torch.linspace(0.5, 6.0, 12, dtype=torch.float64).reshape(3, 4)
    for name in REFERENCE:
        y = getattr(libm, name)(x)
        assert y.shape == x.shape and y.dtype == torch.float64, name


def cuh_text() -> str:
    return CUH.read_text()


def cuh_array(name: str) -> list:
    m = re.search(r"double " + name + r"\[\d+\] = \{(.*?)\};", cuh_text(), re.S)
    assert m, name
    return libm.parse_table(m.group(1))


@pytest.mark.parametrize("table", ["SINCOS_TAB", "LOG_TAB"])
def test_device_tables_equal_the_plain_ones(table):
    device = {"SINCOS_TAB": "kSincosTab", "LOG_TAB": "kLogTab"}[table]
    want = libm.parse_table(getattr(libm, table))
    assert cuh_array(device) == want
    assert len(want) == {"SINCOS_TAB": 440, "LOG_TAB": 256}[table]


def test_device_constants_equal_the_plain_ones():
    text = cuh_text()
    names = re.findall(r"constexpr double (\w+) = ([^;]+);", text)
    arrays = re.findall(r"__constant__ double (\w+)\[\d+\]", text)
    assert len(names) >= 20 and len(arrays) == 8
    for name, value in names:
        assert float.fromhex(value) == getattr(libm, name), name
    for name in arrays:
        assert tuple(cuh_array(name)) == getattr(libm, name), name
