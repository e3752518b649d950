"""Inputs of the transcendental functions of
``repro_torch.kernels.geom.libm``, made from a seed with numpy: 10^6 over
the domain the RHG path gives each function, and the branch and table
boundaries of its algorithm a few ulp to either side.  Shared by the CPU
tests against the reference (``test_torch_libm.py``) and the card tests of
the device versions (``test_torch_cuda.py``), which import no JAX.
"""
import math

import numpy as np

from repro_torch.kernels.geom import libm

N = 10 ** 6


def around(points, ulps: int = 3) -> np.ndarray:
    """Each point and its ``ulps`` neighbours to either side."""
    x = np.asarray(points, np.float64)
    out = [x]
    up, down = x.copy(), x.copy()
    for _ in range(ulps):
        up, down = np.nextafter(up, np.inf), np.nextafter(down, -np.inf)
        out += [up, down]
    return np.concatenate(out)


def log_uniform(rng, lo: float, hi: float, n: int) -> np.ndarray:
    return np.exp(rng.uniform(math.log(lo), math.log(hi), n))


def radii(rng) -> np.ndarray:
    """r >= 1e-12, as the features clamp it: log-uniform up to 700."""
    return np.concatenate([log_uniform(rng, 1e-12, 700.0, N), around([1e-12, 0.5, 1.0, 2.0])])


def exp_inputs(rng) -> np.ndarray:
    r = radii(rng)
    lo, hi = libm.EXP_LO, libm.EXP_HI
    return np.concatenate([r - math.log(2), -math.log(2) - r, around([lo, hi, 0.0, -0.0]),
                           np.arange(-1080, 1080) * math.log(2) / 2])


def log1p_inputs(rng) -> np.ndarray:
    """x >= 0: the arccosh argument sqrt(x - 1)(sqrt(x + 1) + sqrt(x - 1)),
    0 or at least 2^-26 (XLA flushes subnormal inputs to 0; the path
    gives none)."""
    x = np.concatenate([rng.uniform(0.0, 0.5, N // 2), log_uniform(rng, 1e-300, 1e300, N // 2)])
    edges = around([2.0 ** -1022, 1e-12, libm.LOG1P_SMALL, 1.0])
    return np.concatenate([x, [0.0], edges[edges >= 2.0 ** -1022]])


def log_table_knots() -> np.ndarray:
    """The edges of log's 128 table intervals, on both sides of 1 and in
    the 2^1023 binade."""
    i = np.arange(129, dtype=np.int64)
    knots = (libm.LOG_OFF + (i << 45)).view(np.float64)
    return np.concatenate([knots * s for s in (2.0, 4.0, 2.0 ** 20, 2.0 ** 1022, 2.0 ** -10)])


def log_inputs(rng) -> np.ndarray:
    """glibc's main path: x >= sqrt(2) (log1p's and arccosh's arguments)
    and the other normal numbers outside [1 - 2^-4, 1 + 0x1.09p-4)."""
    x = np.concatenate([log_uniform(rng, math.sqrt(2), 1.7e308, N // 2),
                        log_uniform(rng, 2.3e-308, 0.9375, N // 4),
                        rng.uniform(1.0 + 0x109 / 2 ** 12, 1.5, N // 4)])
    edges = around(log_table_knots(), 2)
    return np.concatenate([x, edges[(edges > 1.0 + 0x109 / 2 ** 12) | (edges < 0.9375)],
                           around([math.sqrt(2), 2.0 ** 1023])])


def angles(rng) -> np.ndarray:
    """θ = (cell + u) w in [0, 2π), and every branch boundary of glibc's
    sin and cos: 2^-27, 2^-26, 0.126, the k / 128 rounding knots,
    0.855469, 2.426265, the multiples of π/4 and π/2."""
    theta = rng.uniform(0.0, 2 * math.pi, N)
    hw = [0x3E400000, 0x3E500000, libm.SC_SMALL, libm.SC_MID]
    words = (np.asarray(hw, np.int64) << 32).view(np.float64)
    knots = (np.arange(0, 111) + 0.5) / 128
    quarters = np.arange(0, 9) * math.pi / 4
    special = around(np.concatenate([words, [libm.SC_TAYLOR, 0.0], knots, quarters,
                                     math.pi / 2 - knots]), 4)
    return np.concatenate([theta, special[special >= 0], -theta[:1000], -special])


#: the inputs of each function, by name
INPUTS = {"xla_exp": exp_inputs, "xla_expm1": radii, "xla_log1p": log1p_inputs,
          "glibc_log": log_inputs, "glibc_sin": angles, "glibc_cos": angles}
