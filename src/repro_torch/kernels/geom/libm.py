"""Plain PyTorch versions of the transcendental functions that the JAX
package's RHG programs run on the CPU, bit for bit.

The reference's radii and hyperbolic features (``repro.distrib.engine``:
``_point_cell_fn`` and ``_pair_fn``'s ``hyp_features``) go through six
functions, and XLA compiles each in one of two ways:

* ``exp``, ``expm1`` (with ``tanh``) and ``log1p`` are XLA-CPU's own
  inline expansions (:func:`xla_exp`, :func:`xla_expm1`,
  :func:`xla_log1p`).  The constants below are those of the optimised
  LLVM IR of the reference's fused programs, and the multiply-adds that
  LLVM contracts (``-fp-contract=fast``: every multiply whose one use is
  an add) are the ``vfmadd``/``vfnmadd`` of their compiled objects.
  Read from jaxlib 0.9.0 (XLA at that release; Apache-2.0).
* ``log`` (``log1p`` above sqrt(2) - 1, ``arccosh`` from 2^1023 on),
  ``sin`` and ``cos`` are calls into the C library.  These are glibc
  2.36's (Debian 2.36-9+deb12u13) ``__log_fma``, ``__sin_fma`` and
  ``__cos_fma``, the variants its ifuncs select on a CPU with FMA and
  AVX2 (:func:`glibc_log`, :func:`glibc_sin`, :func:`glibc_cos`).  They
  follow ``sysdeps/ieee754/dbl-64/e_log.c`` (from Arm's
  optimized-routines) and ``s_sin.c`` (IBM Accurate Mathematical
  Library) as GCC compiled them with FMA contraction; the contractions,
  the constants and the two tables (``__sincostab``, the ``invc, logc``
  pairs of ``__log_data``) are read from ``libm.so.6``'s code and
  ``.rodata``.  glibc is LGPL-2.1-or-later; these tables and the order
  of operations are reproduced from it under that licence.

Correct rounding would not do: glibc's ``sin`` is not correctly rounded
on every input, and XLA's expansions are a few ulp off.  Each function
here computes the same operations in the same order, with
:func:`~repro_torch.kernels.delaunay.predicates.fma` (one rounding)
exactly where the compiled code fuses, so it equals its reference on
every input of its domain.  Only the branches that the RHG path reaches
are written; each docstring states its domain.  ``csrc/libm.cuh`` holds
the device versions, with the same constants and tables.

Branches are selected with ``torch.where``: every branch is computed on
every element, so each stays finite (table indices are clamped) and the
unselected values are dropped.
"""
from __future__ import annotations

import struct
from typing import Dict

import torch

from ..delaunay.predicates import fma as _fma_t

_F64 = torch.float64


def _b(bits: int) -> float:
    """The float64 of IEEE bits ``bits`` (as the IR and ``.rodata`` hold them)."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# ---- XLA-CPU's exp (xla.exp.f64) -------------------------------------
EXP_HI = _b(0x40862E42FEFA39EF)        # 709.78...: above, +inf
EXP_LO = _b(0xC086232BDD7ABCD2)       # -708.39...: below, 0
EXP_LOG2E = _b(0x3FF71547652B82FE)
EXP_C1 = _b(0x3FE62E4000000000)        # log 2 = C1 + C2
EXP_C2 = _b(0x3EB7F7D1CF79ABCA)
EXP_P = (_b(0x3F2089CDD5E44BE8), _b(0x3F9F06D10CCA2C7E))
EXP_Q = (_b(0x3EC92EB6BC365FA0), _b(0x3F64AE39B508B6C0),
         _b(0x3FCD17099887E074))

# ---- XLA-CPU's tanh (xla.tanh.f64), inside its expm1 ------------------
TANH_CLAMP = _b(0x4031B6D58F246197)    # 17.71...
TANH_P = tuple(map(_b, (
    0x3B3F9F82E5D782DF, 0x3C2C3C836C04B4C8, 0x3CEC3379F905E662,
    0x3D929AFF6C8EDD96, 0x3E2525A389DCE7C2, 0x3EA708819BE51CD9,
    0x3F18996F4026A7FA, 0x3F787F80B957ED00, 0x3FC36FBA9B450E5A)))
TANH_Q = tuple(map(_b, (
    0x3BBE8630CF903250, 0x3C90AABCA9A5FEA0, 0x3D4232981AA2BBA8,
    0x3DDEE2F015EA8065, 0x3E681F1947C52304, 0x3EE26C82AB46D140,
    0x3F4B2E7C4D488C04, 0x3FA1998830265B50, 0x3FDF0D32A2F7DC79)))

# ---- XLA-CPU's log1p (xla.log1p.f64) ----------------------------------
LOG1P_SMALL = _b(0x3FDA827999FCEF32)   # sqrt(2) - 1: below, the rational form
LOG1P_P = tuple(map(_b, (
    0x3F07BC0962B395CA, 0x3FDFE818A0FE1A83, 0x401A509F46F4FA53,
    0x403DE9738B8CB9C9, 0x404E798EB86C3351, 0x404C8E7597479A10,
    0x40340A202D99830A)))
LOG1P_Q = tuple(map(_b, (
    0x402E20359E903E37, 0x4054C30B52213498, 0x406BB86590FCFB56,
    0x407351945DC908A5, 0x406B0DB13E48E066, 0x404E0F304466448E)))

# ---- glibc's log (__log_fma; e_log.c, LOG_TABLE_BITS = 7) -------------
LOG_OFF = 0x3FE6000000000000
LOG_LN2HI = _b(0x3FE62E42FEFA3800)
LOG_LN2LO = _b(0x3D2EF35793C76730)
LOG_A = tuple(map(_b, (0xBFE0000000000001, 0x3FD555555551305B,
                       0xBFCFFFFFFFEB4590, 0x3FC999B324F10111,
                       0xBFC55575E506C89F)))
# __log_data.poly1: log(1 + r) near 1, for x in [1 - 2^-4, 1 + 0x1.09p-4)
LOG_B = tuple(map(_b, (0xBFE0000000000000, 0x3FD5555555555577,
                       0xBFCFFFFFFFFFFDCB, 0x3FC999999995DD0C,
                       0xBFC55555556745A7, 0x3FC24924A344DE30,
                       0xBFBFFFFFA4423D65, 0x3FBC7184282AD6CA,
                       0xBFB999EB43B068FF, 0x3FB78182F7AFD085,
                       0xBFB5521375D145CD)))
LOG_NEAR_LO = 0x3FEE000000000000       # bits of 1 - 2^-4
LOG_NEAR_SPAN = 0x3090000000000        # bits of 1 + 0x1.09p-4, less LOG_NEAR_LO
LOG_SPLIT = _b(0x41A0000000000000)     # 2^27: r's split into rhi + rlo
# __log_data.tab: (invc, logc) for i = 0..127
LOG_TAB = """
    0x1.734f0c3e0de9fp+0, -0x1.7cc7f79e69000p-2,
    0x1.713786a2ce91fp+0, -0x1.76feec20d0000p-2,
    0x1.6f26008fab5a0p+0, -0x1.713e31351e000p-2,
    0x1.6d1a61f138c7dp+0, -0x1.6b85b38287800p-2,
    0x1.6b1490bc5b4d1p+0, -0x1.65d5590807800p-2,
    0x1.69147332f0cbap+0, -0x1.602d076180000p-2,
    0x1.6719f18224223p+0, -0x1.5a8ca86909000p-2,
    0x1.6524f99a51ed9p+0, -0x1.54f4356035000p-2,
    0x1.63356aa8f24c4p+0, -0x1.4f637c36b4000p-2,
    0x1.614b36b9ddc14p+0, -0x1.49da7fda85000p-2,
    0x1.5f66452c65c4cp+0, -0x1.445923989a800p-2,
    0x1.5d867b5912c4fp+0, -0x1.3edf439b0b800p-2,
    0x1.5babccb5b90dep+0, -0x1.396ce448f7000p-2,
    0x1.59d61f2d91a78p+0, -0x1.3401e17bda000p-2,
    0x1.5805612465687p+0, -0x1.2e9e2ef468000p-2,
    0x1.56397cee76bd3p+0, -0x1.2941b3830e000p-2,
    0x1.54725e2a77f93p+0, -0x1.23ec58cda8800p-2,
    0x1.52aff42064583p+0, -0x1.1e9e129279000p-2,
    0x1.50f22dbb2bddfp+0, -0x1.1956d2b48f800p-2,
    0x1.4f38f4734ded7p+0, -0x1.141679ab9f800p-2,
    0x1.4d843cfde2840p+0, -0x1.0edd094ef9800p-2,
    0x1.4bd3ec078a3c8p+0, -0x1.09aa518db1000p-2,
    0x1.4a27fc3e0258ap+0, -0x1.047e65263b800p-2,
    0x1.4880524d48434p+0, -0x1.feb224586f000p-3,
    0x1.46dce1b192d0bp+0, -0x1.f474a7517b000p-3,
    0x1.453d9d3391854p+0, -0x1.ea4443d103000p-3,
    0x1.43a2744b4845ap+0, -0x1.e020d44e9b000p-3,
    0x1.420b54115f8fbp+0, -0x1.d60a22977f000p-3,
    0x1.40782da3ef4b1p+0, -0x1.cc00104959000p-3,
    0x1.3ee8f5d57fe8fp+0, -0x1.c202956891000p-3,
    0x1.3d5d9a00b4ce9p+0, -0x1.b81178d811000p-3,
    0x1.3bd60c010c12bp+0, -0x1.ae2c9ccd3d000p-3,
    0x1.3a5242b75dab8p+0, -0x1.a45402e129000p-3,
    0x1.38d22cd9fd002p+0, -0x1.9a877681df000p-3,
    0x1.3755bc5847a1cp+0, -0x1.90c6d69483000p-3,
    0x1.35dce49ad36e2p+0, -0x1.87120a645c000p-3,
    0x1.34679984dd440p+0, -0x1.7d68fb4143000p-3,
    0x1.32f5cceffcb24p+0, -0x1.73cb83c627000p-3,
    0x1.3187775a10d49p+0, -0x1.6a39a9b376000p-3,
    0x1.301c8373e3990p+0, -0x1.60b3154b7a000p-3,
    0x1.2eb4ebb95f841p+0, -0x1.5737d76243000p-3,
    0x1.2d50a0219a9d1p+0, -0x1.4dc7b8fc23000p-3,
    0x1.2bef9a8b7fd2ap+0, -0x1.4462c51d20000p-3,
    0x1.2a91c7a0c1babp+0, -0x1.3b08abc830000p-3,
    0x1.293726014b530p+0, -0x1.31b996b490000p-3,
    0x1.27dfa5757a1f5p+0, -0x1.2875490a44000p-3,
    0x1.268b39b1d3bbfp+0, -0x1.1f3b9f879a000p-3,
    0x1.2539d838ff5bdp+0, -0x1.160c8252ca000p-3,
    0x1.23eb7aac9083bp+0, -0x1.0ce7f57f72000p-3,
    0x1.22a012ba940b6p+0, -0x1.03cdc49fea000p-3,
    0x1.2157996cc4132p+0, -0x1.f57bdbc4b8000p-4,
    0x1.201201dd2fc9bp+0, -0x1.e370896404000p-4,
    0x1.1ecf4494d480bp+0, -0x1.d17983ef94000p-4,
    0x1.1d8f5528f6569p+0, -0x1.bf9674ed8a000p-4,
    0x1.1c52311577e7cp+0, -0x1.adc79202f6000p-4,
    0x1.1b17c74cb26e9p+0, -0x1.9c0c3e7288000p-4,
    0x1.19e010c2c1ab6p+0, -0x1.8a646b372c000p-4,
    0x1.18ab07bb670bdp+0, -0x1.78d01b3ac0000p-4,
    0x1.1778a25efbcb6p+0, -0x1.674f145380000p-4,
    0x1.1648d354c31dap+0, -0x1.55e0e6d878000p-4,
    0x1.151b990275fddp+0, -0x1.4485cdea1e000p-4,
    0x1.13f0ea432d24cp+0, -0x1.333d94d6aa000p-4,
    0x1.12c8b7210f9dap+0, -0x1.22079f8c56000p-4,
    0x1.11a3028ecb531p+0, -0x1.10e4698622000p-4,
    0x1.107fbda8434afp+0, -0x1.ffa6c6ad20000p-5,
    0x1.0f5ee0f4e6bb3p+0, -0x1.dda8d4a774000p-5,
    0x1.0e4065d2a9fcep+0, -0x1.bbcece4850000p-5,
    0x1.0d244632ca521p+0, -0x1.9a1894012c000p-5,
    0x1.0c0a77ce2981ap+0, -0x1.788583302c000p-5,
    0x1.0af2f83c636d1p+0, -0x1.5715e67d68000p-5,
    0x1.09ddb98a01339p+0, -0x1.35c8a49658000p-5,
    0x1.08cabaf52e7dfp+0, -0x1.149e364154000p-5,
    0x1.07b9f2f4e28fbp+0, -0x1.e72c082eb8000p-6,
    0x1.06ab58c358f19p+0, -0x1.a55f152528000p-6,
    0x1.059eea5ecf92cp+0, -0x1.63d62cf818000p-6,
    0x1.04949cdd12c90p+0, -0x1.228fb8caa0000p-6,
    0x1.038c6c6f0ada9p+0, -0x1.c317b20f90000p-7,
    0x1.02865137932a9p+0, -0x1.419355daa0000p-7,
    0x1.0182427ea7348p+0, -0x1.81203c2ec0000p-8,
    0x1.008040614b195p+0, -0x1.0040979240000p-9,
    0x1.fe01ff726fa1ap-1, 0x1.feff384900000p-9,
    0x1.fa11cc261ea74p-1, 0x1.7dc41353d0000p-7,
    0x1.f6310b081992ep-1, 0x1.3cea3c4c28000p-6,
    0x1.f25f63ceeadcdp-1, 0x1.b9fc114890000p-6,
    0x1.ee9c8039113e7p-1, 0x1.1b0d8ce110000p-5,
    0x1.eae8078cbb1abp-1, 0x1.58a5bd001c000p-5,
    0x1.e741aa29d0c9bp-1, 0x1.95c8340d88000p-5,
    0x1.e3a91830a99b5p-1, 0x1.d276aef578000p-5,
    0x1.e01e009609a56p-1, 0x1.07598e598c000p-4,
    0x1.dca01e577bb98p-1, 0x1.253f5e30d2000p-4,
    0x1.d92f20b7c9103p-1, 0x1.42edd8b380000p-4,
    0x1.d5cac66fb5ccep-1, 0x1.606598757c000p-4,
    0x1.d272caa5ede9dp-1, 0x1.7da76356a0000p-4,
    0x1.cf26e3e6b2ccdp-1, 0x1.9ab434e1c6000p-4,
    0x1.cbe6da2a77902p-1, 0x1.b78c7bb0d6000p-4,
    0x1.c8b266d37086dp-1, 0x1.d431332e72000p-4,
    0x1.c5894bd5d5804p-1, 0x1.f0a3171de6000p-4,
    0x1.c26b533bb9f8cp-1, 0x1.067152b914000p-3,
    0x1.bf583eeece73fp-1, 0x1.147858292b000p-3,
    0x1.bc4fd75db96c1p-1, 0x1.2266ecdca3000p-3,
    0x1.b951e0c864a28p-1, 0x1.303d7a6c55000p-3,
    0x1.b65e2c5ef3e2cp-1, 0x1.3dfc33c331000p-3,
    0x1.b374867c9888bp-1, 0x1.4ba366b7a8000p-3,
    0x1.b094b211d304ap-1, 0x1.5933928d1f000p-3,
    0x1.adbe885f2ef7ep-1, 0x1.66acd2418f000p-3,
    0x1.aaf1d31603da2p-1, 0x1.740f8ec669000p-3,
    0x1.a82e63fd358a7p-1, 0x1.815c0f51af000p-3,
    0x1.a5740ef09738bp-1, 0x1.8e92954f68000p-3,
    0x1.a2c2a90ab4b27p-1, 0x1.9bb3602f84000p-3,
    0x1.a01a01393f2d1p-1, 0x1.a8bed1c2c0000p-3,
    0x1.9d79f24db3c1bp-1, 0x1.b5b515c01d000p-3,
    0x1.9ae2505c7b190p-1, 0x1.c2967ccbcc000p-3,
    0x1.9852ef297ce2fp-1, 0x1.cf635d5486000p-3,
    0x1.95cbaeea44b75p-1, 0x1.dc1bd3446c000p-3,
    0x1.934c69de74838p-1, 0x1.e8c01b8cfe000p-3,
    0x1.90d4f2f6752e6p-1, 0x1.f5509c0179000p-3,
    0x1.8e6528effd79dp-1, 0x1.00e6c121fb800p-2,
    0x1.8bfce9fcc007cp-1, 0x1.071b80e93d000p-2,
    0x1.899c0dabec30ep-1, 0x1.0d46b9e867000p-2,
    0x1.87427aa2317fbp-1, 0x1.13687334bd000p-2,
    0x1.84f00acb39a08p-1, 0x1.1980d67234800p-2,
    0x1.82a49e8653e55p-1, 0x1.1f8ffe0cc8000p-2,
    0x1.8060195f40260p-1, 0x1.2595fd7636800p-2,
    0x1.7e22563e0a329p-1, 0x1.2b9300914a800p-2,
    0x1.7beb377dcb5adp-1, 0x1.3187210436000p-2,
    0x1.79baa679725c2p-1, 0x1.377266dec1800p-2,
    0x1.77907f2170657p-1, 0x1.3d54ffbaf3000p-2,
    0x1.756cadbd6130cp-1, 0x1.432eee32fe000p-2,
"""

# ---- glibc's sin and cos (__sin_fma, __cos_fma; s_sin.c) --------------
SC_BIG = _b(0x42C8000000000000)       # 52776558133248: rounds |x| to 1/128
SC_HP0 = _b(0x3FF921FB54442D18)        # pi/2 = hp0 + hp1
SC_HP1 = _b(0x3C91A62633145C07)
SC_TOINT = _b(0x4338000000000000)
SC_HPINV = _b(0x3FE45F306DC9C883)      # 2/pi
SC_MP1 = _b(0x3FF921FB58000000)        # pi/2 = mp1 + mp2 + pp3 + pp4
SC_MP2 = _b(0xBE4DDE973C000000)
SC_PP3 = _b(0xBC8CB3B398000000)
SC_PP4 = _b(0xBACD747F23E32ED7)
SC_TAYLOR = _b(0x3FC020C49BA5E354)     # 0.126: below, TAYLOR_SIN
SC_S = tuple(map(_b, (0xBFC5555555555555, 0x3F81111111110ECE,
                      0xBF2A01A019DB08B8, 0x3EC71DE27B9A7ED9,
                      0xBE5ADDFFC2FCDF59)))            # s1..s5
SC_SN3, SC_SN5 = _b(0xBFC5555555555515), _b(0x3F811110E829872F)
SC_CS2, SC_CS4, SC_CS6 = (_b(0x3FE0000000000000), _b(0xBFA5555555555535),
                          _b(0x3F56C16BEDD9E239))
# high words bounding the branches of sin and cos
SIN_TINY, COS_TINY = 0x3E500000, 0x3E400000    # 2^-26, 2^-27
SC_SMALL, SC_MID, SC_RED = 0x3FEB6000, 0x400368FD, 0x419921FB   # 0.855469, 2.426265, 105414350
# __sincostab: (sn, ssn, cs, ccs) of k / 128, k = 0..109
SINCOS_TAB = """
    0x0.0p+0, 0x0.0p+0, 0x1.0000000000000p+0, 0x0.0p+0,
    0x1.fffeaaaaeeeefp-8, -0x1.e45e2ec67b77cp-62, 0x1.fffc000155552p-1, 0x1.f4a01a0196daep-55,
    0x1.fffaaaaeeeed5p-7, -0x1.2ab639a9f0777p-63, 0x1.fff000155549fp-1, 0x1.28a28a03a5ef3p-55,
    0x1.7ff7001033255p-6, 0x1.efe2b51527336p-64, 0x1.ffdc006bff7e6p-1, 0x1.ae6dae86977bdp-55,
    0x1.ffeaaaeeee86fp-6, -0x1.cd406fb224ae2p-60, 0x1.ffc00155527d3p-1, -0x1.3b54492d89b5bp-55,
    0x1.3feb2b12d45d5p-5, 0x1.4ec54203d1c11p-60, 0x1.ff9c03414a7bap-1, 0x1.991f4be6c59bfp-57,
    0x1.7fdc01032fba9p-5, -0x1.599bdf46e997ap-59, 0x1.ff7006bfdf99fp-1, -0x1.8b3b560648d5fp-56,
    0x1.bfc6d78586dacp-5, 0x1.8e4fd03dbf236p-62, 0x1.ff3c0c8103a31p-1, 0x1.4856dbddc0e66p-56,
    0x1.ffaaaeeed4edbp-5, -0x1.2d16d32684b69p-59, 0x1.ff0015549f4d3p-1, 0x1.328387b99426fp-55,
    0x1.1fc343d808befp-4, -0x1.f3d32e6f3be4fp-58, 0x1.febc222a8ef9fp-1, 0x1.7934934f54c77p-58,
    0x1.3facb12d1755bp-4, -0x1.921915299468cp-58, 0x1.fe7034129ef6fp-1, -0x1.cbf4337c96f97p-57,
    0x1.5f911fd10b737p-4, -0x1.0184f02be9102p-58, 0x1.fe1c4c3c873ebp-1, -0x1.5a9c9057c4a02p-60,
    0x1.7f701032550e4p-4, 0x1.afc2d1800501ap-60, 0x1.fdc06bf7e6b9bp-1, 0x1.31902b535f8dbp-55,
    0x1.9f4902d55d1f9p-4, 0x1.2696d7eac1dc1p-58, 0x1.fd5c94b43e000p-1, -0x1.2e768cb4f92f9p-57,
    0x1.bf1b78568391dp-4, 0x1.e91841dea4cc8p-58, 0x1.fcf0c800e99b1p-1, 0x1.ea3d786d186acp-57,
    0x1.dee6f16c1cce6p-4, -0x1.50f8e2fb71673p-59, 0x1.fc7d078d1bc88p-1, 0x1.075d2447db685p-55,
    0x1.feaaeee86ee36p-4, -0x1.afcb2bcc6f03bp-59, 0x1.fc015527d5bd3p-1, 0x1.b68f35094efb8p-55,
    0x1.0f3378ddd71d1p-3, 0x1.d8468724f0f9ep-57, 0x1.fb7db2bfe0695p-1, 0x1.21dadf4f65ab1p-55,
    0x1.1f0d3d7afceafp-3, -0x1.6ef95099769a5p-57, 0x1.faf22263c4bd3p-1, -0x1.52ace133a2769p-58,
    0x1.2ee285e4ab88fp-3, -0x1.e4d0f05dee058p-57, 0x1.fa5ea641c36f2p-1, 0x1.04da6ed17cc7cp-59,
    0x1.3eb312c5d66cbp-3, 0x1.47d666b66cb91p-57, 0x1.f9c340a7cc428p-1, 0x1.c5b6b063b7462p-55,
    0x1.4e7ea4dc5f27bp-3, 0x1.949db2ac072fcp-58, 0x1.f91ff40374d01p-1, -0x1.7d03f4d3a9e4cp-57,
    0x1.5e44fcfa126f3p-3, -0x1.6f443063f89b6p-57, 0x1.f874c2e1eecf6p-1, -0x1.c6514e1332b16p-55,
    0x1.6e05dc05a4d4cp-3, -0x1.32c5c8b81c940p-66, 0x1.f7c1afeffde24p-1, -0x1.8f55bc47540b1p-56,
    0x1.7dc102fbaf2b5p-3, 0x1.5ab50e23c97c3p-59, 0x1.f706bdf9ece1cp-1, -0x1.698c80c36dcb4p-55,
    0x1.8d7632efaa944p-3, -0x1.20fa262cbb953p-57, 0x1.f643efeb82acdp-1, 0x1.6b00ac1fe28acp-56,
    0x1.9d252d0cec312p-3, 0x1.9c43d80b1137dp-58, 0x1.f57948cff6797p-1, 0x1.e3a0d3e03b1d5p-57,
    0x1.accdb297a0765p-3, -0x1.9883b57d6cdebp-58, 0x1.f4a6cbd1e3a79p-1, 0x1.13df0edaebb57p-55,
    0x1.bc6f84edc6199p-3, 0x1.9c1a56a7b0cabp-57, 0x1.f3cc7c3b3d16ep-1, -0x1.21a3ad28a3494p-57,
    0x1.cc0a6588289a3p-3, -0x1.868d09bc87c6bp-57, 0x1.f2ea5d753ffedp-1, 0x1.cc4215f56d583p-55,
    0x1.db9e15fb5a5d0p-3, -0x1.32e20d6cc6fc2p-57, 0x1.f20073086649fp-1, 0x1.b940416c1984bp-56,
    0x1.eb2a57f8ae5a3p-3, -0x1.0be06af572cebp-57, 0x1.f10ec09c5873bp-1, 0x1.d9072762c1283p-55,
    0x1.faaeed4f31577p-3, -0x1.15d88508e32b8p-57, 0x1.f01549f7deea1p-1, 0x1.d3c1e99e5cafdp-55,
    0x1.0515cbf65155cp-2, -0x1.9b8c29dfd8ec8p-56, 0x1.ef141300d2f26p-1, -0x1.2aa1b08ded372p-55,
    0x1.0cd00cef36436p-2, -0x1.9fb0a0c93e2b5p-56, 0x1.ee0b1fbc0f11cp-1, -0x1.bfd2380bbc3b1p-59,
    0x1.14861aa94ddebp-2, -0x1.be881b5b615a4p-57, 0x1.ecfa744d5efa1p-1, -0x1.56d0a4af541d0p-58,
    0x1.1c37d64c6b876p-2, 0x1.46076fe0dcff5p-56, 0x1.ebe214f76efa8p-1, -0x1.02f9f12ba543ep-55,
    0x1.23e52111aaf36p-2, -0x1.4f080334eff18p-56, 0x1.eac2061bbaf4fp-1, 0x1.2c1d53e94658dp-57,
    0x1.2b8ddc43eb49fp-2, 0x1.1553899f2d807p-57, 0x1.e99a4c3a7cd83p-1, -0x1.2264b1bc53ce8p-55,
    0x1.3331e94049f87p-2, 0x1.e0cb6b40c302cp-56, 0x1.e86aebf29a9edp-1, 0x1.9397afdbb58a7p-55,
    0x1.3ad129769d3d8p-2, 0x1.03d5504878398p-63, 0x1.e733ea0193d40p-1, -0x1.6428b3546ce13p-55,
    0x1.426b7e69ee697p-2, -0x1.f09c75705c59fp-56, 0x1.e5f54b436e9d0p-1, 0x1.7eb0fd02fc8bcp-55,
    0x1.4a00c9b0f3d20p-2, 0x1.823ba6bb08eadp-56, 0x1.e4af14b2a449cp-1, -0x1.68ca02e8a6833p-55,
    0x1.5190ecf68a77ap-2, 0x1.b357155eef0f3p-56, 0x1.e3614b680d6a5p-1, -0x1.27793aa015237p-56,
    0x1.591bc9fa2f597p-2, 0x1.7c74bac3fe0cbp-57, 0x1.e20bf49acd6c1p-1, -0x1.660aec7ef636cp-58,
    0x1.60a1429078775p-2, 0x1.b1fd80ba89133p-58, 0x1.e0af15a03dbcep-1, 0x1.fe8e702771ae6p-58,
    0x1.682138a38d7f7p-2, -0x1.d889202444aadp-56, 0x1.df4ab3ebd875ep-1, -0x1.e2d8a7e6736c4p-55,
    0x1.6f9b8e33a0255p-2, 0x1.42bc14ee9da0dp-56, 0x1.ddded50f228d6p-1, -0x1.e80c8d42ba2bfp-57,
    0x1.7710255764214p-2, -0x1.6ead7314bb6cep-57, 0x1.dc6b7eb995912p-1, 0x1.4b364776dcd35p-58,
    0x1.7e7ee03c86d4ep-2, -0x1.b63bcdabf5af2p-56, 0x1.daf0b6b888e83p-1, 0x1.a249e2b5e5ceap-55,
    0x1.85e7a12826949p-2, 0x1.8a40e9b5face0p-56, 0x1.d96e82f71a9dcp-1, 0x1.ff61bd5d2039dp-55,
    0x1.8d4a4a774992fp-2, 0x1.44a02ea766326p-56, 0x1.d7e4e97e17b4ap-1, -0x1.3b770352bed94p-57,
    0x1.94a6be9f546c5p-2, -0x1.69ce13e683f58p-56, 0x1.d653f073e4040p-1, -0x1.76236434bec37p-55,
    0x1.9bfce02e80510p-2, 0x1.09e39a320b0a4p-56, 0x1.d4bb9e1c619e0p-1, 0x1.f34bb77858f61p-55,
    0x1.a34c91cc50ccap-2, -0x1.a310e3b50cecdp-58, 0x1.d31bf8d8d7c06p-1, 0x1.e60dd3089cbddp-56,
    0x1.aa95b63a09277p-2, -0x1.6293eb13c0381p-57, 0x1.d1750727d94f0p-1, 0x1.0d52b1ec1a48ep-55,
    0x1.b1d8305321617p-2, -0x1.ae242cb99f519p-56, 0x1.cfc6cfa52ad9fp-1, 0x1.8b5b5508f2a0dp-55,
    0x1.b913e30dbac43p-2, -0x1.e38ad2f6c3ff1p-56, 0x1.ce115909a82e5p-1, 0x1.1f139bb31109ap-55,
    0x1.c048b17b140a3p-2, 0x1.19fe6757e9fa7p-57, 0x1.cc54aa2b2972ep-1, 0x1.4ee162ba83a98p-57,
    0x1.c7767ec7fd19ep-2, -0x1.eb14d1a3d5826p-58, 0x1.ca90c9fc67d0bp-1, -0x1.46a81485e3462p-57,
    0x1.ce9d2e3d4a51fp-2, -0x1.2fc8a12dae298p-57, 0x1.c8c5bf8ce1a84p-1, 0x1.ab3d1a1590123p-56,
    0x1.d5bca34047661p-2, 0x1.28a44a75fc29cp-56, 0x1.c6f39208be53bp-1, -0x1.741dbfbaadb42p-55,
    0x1.dcd4c15329c9ap-2, 0x1.0d4c6e171fd9ap-56, 0x1.c51a48b8b175ep-1, -0x1.1bbb43b9aa880p-57,
    0x1.e3e56c1582a69p-2, -0x1.0a4821099f88fp-58, 0x1.c339eb01ddd81p-1, -0x1.caaf5ee82c5c0p-55,
    0x1.eaee8744b05f0p-2, -0x1.789b43c9b027dp-58, 0x1.c1528065b7d50p-1, -0x1.892111312e828p-55,
    0x1.f1eff6bc4f97bp-2, 0x1.17212f8a7525cp-56, 0x1.bf641081e7536p-1, 0x1.b7bd71628a9a1p-55,
    0x1.f8e99e76abc97p-2, 0x1.9d950af2d00a3p-58, 0x1.bd6ea310294f5p-1, 0x1.31bbcc88c109dp-56,
    0x1.ffdb628d2f57ap-2, 0x1.f4a992e905b6ap-57, 0x1.bb723fe630f32p-1, 0x1.72bd2452d0a39p-56,
    0x1.0362939c69955p-1, -0x1.2d8cd78397b01p-55, 0x1.b96eeef58840ep-1, 0x1.45a3cc78fade0p-58,
    0x1.06d3686946e5bp-1, 0x1.3f5ae4538ff1bp-55, 0x1.b764b84b704c2p-1, -0x1.f5848c21b389bp-55,
    0x1.0a4021e9e1001p-1, -0x1.6f643a13914f6p-55, 0x1.b553a410c104ep-1, 0x1.8ff7947027a16p-58,
    0x1.0da8b26b5672ep-1, -0x1.a58def0bee909p-55, 0x1.b33bba89c8948p-1, 0x1.ea6a51d1f6ca9p-55,
    0x1.110d0c4b69c3bp-1, 0x1.d918998809981p-55, 0x1.b11d04162a4c6p-1, 0x1.1dd561efbc0c2p-56,
    0x1.146d21f8b7f82p-1, 0x1.bf9535e2739a8p-56, 0x1.aef78930bd275p-1, -0x1.f836279746f94p-56,
    0x1.17c8e5f2eedb0p-1, 0x1.35e57102e2488p-57, 0x1.accb526f69de5p-1, 0x1.8fb6a8dd6b6ccp-55,
    0x1.1b204acb02fddp-1, -0x1.f190c70cbb5ffp-58, 0x1.aa98688308913p-1, -0x1.b83d607cd5070p-63,
    0x1.1e7343236574cp-1, 0x1.22a3fa4f41d5ap-56, 0x1.a85ed4373e02dp-1, 0x1.9be06385ec792p-57,
    0x1.21c1c1b0394cfp-1, 0x1.e5b324b23aa31p-58, 0x1.a61e9e72586afp-1, 0x1.58330e2fd453fp-55,
    0x1.250bb93788bbbp-1, 0x1.ea3d02457bccep-56, 0x1.a3d7d0352bdcfp-1, -0x1.68dbaeca19669p-55,
    0x1.28511c917a067p-1, -0x1.01df1d9a16b70p-55, 0x1.a18a729aee445p-1, 0x1.95e25736c0358p-60,
    0x1.2b91dea88421ep-1, -0x1.fa371db216ab0p-55, 0x1.9f368ed912f85p-1, -0x1.1d200c5791606p-55,
    0x1.2ecdf279a3082p-1, 0x1.d3557e0e7e37ep-55, 0x1.9cdc2e3f25e5cp-1, 0x1.3f99112993f62p-55,
    0x1.32054b148bc4fp-1, 0x1.f6b42095a135bp-55, 0x1.9a7b5a36a6514p-1, 0x1.722cfcc9fa7a9p-55,
    0x1.3537db9be0367p-1, 0x1.b327e7af040f0p-57, 0x1.98141c42e1310p-1, 0x1.d1ff80488f08dp-55,
    0x1.386597456282bp-1, -0x1.10fada93b07a8p-56, 0x1.95a67e00cb1fdp-1, -0x1.0befda21f862dp-55,
    0x1.3b8e715a2840ap-1, -0x1.97653a7d2f07bp-56, 0x1.93328926d9e92p-1, -0x1.bb77003600cdap-55,
    0x1.3eb25d36cd53ap-1, -0x1.be570e1570fc0p-58, 0x1.90b84784ddaf7p-1, -0x1.0feb10ab93b87p-56,
    0x1.41d14e4ba6790p-1, 0x1.4608fd287ecf5p-55, 0x1.8e37c303d9ad1p-1, -0x1.463a4b53d4bf8p-57,
    0x1.44eb381cf386bp-1, -0x1.3ed6c1e6a5505p-55, 0x1.8bb105a5dc900p-1, 0x1.863e03e9474c1p-55,
    0x1.48000e431159fp-1, -0x1.b194a7463ed10p-55, 0x1.89241985d871fp-1, 0x1.c48d9c413ed84p-55,
    0x1.4b0fc46aab761p-1, 0x1.0da05738cc59ap-61, 0x1.869108d77a6c6p-1, 0x1.338ffe2bfe9ddp-56,
    0x1.4e1a4e54ed51bp-1, -0x1.a492f89b7c76ap-55, 0x1.83f7dde701ca0p-1, -0x1.152cf609bc6e8p-59,
    0x1.511f9fd7b351cp-1, -0x1.5c0e861c48831p-55, 0x1.8158a31916d5dp-1, -0x1.de8b90b8228dep-57,
    0x1.541facddbb724p-1, 0x1.232c28520d391p-56, 0x1.7eb362eaa1488p-1, 0x1.a1d65a4a5959fp-58,
    0x1.571a6966d59b3p-1, 0x1.c843b4d0fb198p-58, 0x1.7c0827f09e54fp-1, -0x1.c73d6d72aee68p-57,
    0x1.5a0fc98813a12p-1, -0x1.d82e2b7d4227bp-55, 0x1.7956fcd7f6543p-1, -0x1.ab276e9d45ae4p-55,
    0x1.5cffc16bf8f0dp-1, 0x1.96cb370eb578ap-55, 0x1.769fec655211fp-1, -0x1.827d5cf8c68c5p-57,
    0x1.5fea4552a9e57p-1, 0x1.0b6cef7ee20b7p-55, 0x1.73e30174efba1p-1, -0x1.5d3ae3d94ad5fp-57,
    0x1.62cf49921ac79p-1, -0x1.edd9855b6241ap-55, 0x1.712046fa77678p-1, 0x1.425b0a5029c81p-55,
    0x1.65aec2963e755p-1, 0x1.126f96b71053cp-55, 0x1.6e57c800cf55ep-1, 0x1.60286dedbd0a6p-55,
    0x1.6888a4e134b2fp-1, -0x1.6b7d37644d5e6p-55, 0x1.6b898fa9efb5dp-1, 0x1.15ac786ccf4b2p-56,
    0x1.6b5ce50b7821ap-1, -0x1.5d5158f702e0fp-57, 0x1.68b5a92eb6253p-1, -0x1.9a91ad985f89cp-55,
    0x1.6e2b77c40bde1p-1, -0x1.0e729857fad53p-56, 0x1.65dc1fdeb8cbap-1, -0x1.97c1b47337c77p-58,
    0x1.70f451d0a8c40p-1, 0x1.97ede3885770dp-57, 0x1.62fcff20191c7p-1, 0x1.d9143895756efp-57,
    0x1.73b7680dea578p-1, -0x1.2248306dc12a2p-56, 0x1.6018526f563dfp-1, 0x1.46ca5e0e432d0p-55,
    0x1.7674af6f7b524p-1, 0x1.e9d3f94ac84a8p-56, 0x1.5d2e255f1f17ap-1, 0x1.0314104c8892bp-55,
    0x1.792c1d0041d52p-1, -0x1.abf05eeb354ebp-55, 0x1.5a3e839824077p-1, 0x1.428aa2759be62p-55,
    0x1.7bdda5e28b3c2p-1, 0x1.ad1197ccd0393p-59, 0x1.574978d8e83f2p-1, 0x1.f4714af282d23p-55,
    0x1.7e893f5037959p-1, 0x1.0eefbaa650c4cp-55, 0x1.544f10f592ca5p-1, -0x1.e7ae8e6c7a62fp-55,
    0x1.812ede9ae4ba4p-1, -0x1.7830adf402ddap-55, 0x1.514f57d7bf3dap-1, 0x1.47a108073c259p-56,
"""


def parse_table(text: str):
    """The floats of a table written as comma-separated hex floats (as
    here and in ``csrc/libm.cuh``)."""
    return [float.fromhex(v) for v in text.replace("\n", " ").split(",") if v.strip()]


_TABLES: Dict[tuple, torch.Tensor] = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.tensor(parse_table({"log": LOG_TAB, "sincos": SINCOS_TAB}[name]),
                         dtype=_F64, device=device)
        _TABLES[key] = t
    return t


def _fma(a, b, c):
    """``a * b + c`` rounded once; Python floats become 0-d tensors on the
    tensor operands' device."""
    ref = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    a, b, c = (v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=_F64, device=ref.device)
               for v in (a, b, c))
    return _fma_t(a, b, c)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64)


def _from_bits(i: torch.Tensor) -> torch.Tensor:
    return i.view(_F64)


def _high_word(x: torch.Tensor) -> torch.Tensor:
    """``|x|``'s upper 32 bits."""
    return (_bits(x) >> 32) & 0x7FFFFFFF


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``fma(... fma(fma(c0, x, c1), x, c2) ..., x, cn)``: every step one
    fused multiply-add, as the compiled code has it."""
    acc = _fma(x, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        acc = _fma(acc, x, c)
    return acc


# ---------------------------------------------------------------- XLA --

def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's ``exp`` of float64 ``x``: a Pade form in ``g = x - n log
    2`` and a scaling by ``2^n`` in two steps.  Domain: every float64."""
    xc = torch.clamp(x, EXP_LO, EXP_HI)
    n = torch.floor(_fma(xc, EXP_LOG2E, 0.5))
    g = _fma(-n, EXP_C2, _fma(-n, EXP_C1, xc))
    gg = g * g
    p = _horner(gg, EXP_P + (1.0,)) * g
    q = _horner(gg, EXP_Q + (2.0,))
    e = _fma(p / (q - p), 2.0, 1.0)
    ni = n.nan_to_num().to(torch.int64).clamp(-2099, 2099)
    b = ni >> 2
    s = _from_bits((b << 52) + 0x3FF0000000000000)
    e = e * s * s * s * _from_bits(((ni - 3 * b) << 52) + 0x3FF0000000000000)
    e = torch.where(x < EXP_LO, torch.zeros_like(e), e)
    return torch.where(x > EXP_HI, torch.full_like(e, float("inf")), e)


def _xla_tanh(y: torch.Tensor) -> torch.Tensor:
    c = torch.where(y < -TANH_CLAMP, torch.full_like(y, -TANH_CLAMP), y)
    c = torch.where(c > TANH_CLAMP, torch.full_like(y, TANH_CLAMP), c)
    c2 = c * c
    t = c * _horner(c2, TANH_P + (1.0,)) / _horner(c2, TANH_Q + (1.0,))
    return torch.where(y.abs() >= 20.0, torch.copysign(torch.ones_like(y), y), t)


def xla_expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's ``expm1`` of float64 ``x``: ``exp(x) - 1`` above 1/2 in
    magnitude, ``tanh(x / 2) (exp(x) + 1)`` below.  Domain: every
    float64."""
    e = xla_exp(x)
    y = x * 0.5
    out = torch.where(x.abs() > 0.5, e - 1.0, _xla_tanh(y) * (e + 1.0))
    return torch.where(y == 0.0, x, out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's ``log1p`` of float64 ``x``: ``x - x^2 / 2 + x^3 P(x) /
    Q(x)`` below sqrt(2) - 1 in magnitude, ``log(1 + x)`` above.  Domain:
    0 and finite normal ``x > 0`` (the ``log`` side then takes ``1 + x >=
    sqrt(2)``, inside :func:`glibc_log`'s domain; XLA flushes a subnormal
    input to 0, which this function does not)."""
    x2 = x * x
    ratio = _horner(x, LOG1P_P) / _horner(x, (1.0,) + LOG1P_Q)
    small = x + _fma(x2, -0.5, x * x2 * ratio)
    return torch.where(x.abs() < LOG1P_SMALL, small, glibc_log(x + 1.0))


# -------------------------------------------------------------- glibc --

def glibc_log(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``log`` of float64 ``x``: ``log(x) = k log 2 + log(c) +
    log1p(z / c - 1)`` with ``c`` from a 128-entry table.  Domain: finite
    normal ``x > 0`` outside [1 - 2^-4, 1 + 0x1.09p-4), which glibc
    computes with another polynomial that the RHG path never reaches."""
    ix = _bits(x)
    tmp = ix - LOG_OFF
    i = (tmp >> 45) & 127
    k = tmp >> 52
    z = _from_bits(ix - (tmp & -(1 << 52)))
    tab = _table("log", x.device)
    invc, logc = tab[2 * i], tab[2 * i + 1]
    r = _fma(z, invc, -1.0)
    kd = k.to(_F64)
    w = _fma(kd, LOG_LN2HI, logc)
    hi = w + r
    lo = _fma(kd, LOG_LN2LO, (w - hi) + r)
    r2 = r * r
    A = LOG_A
    p = _fma(_fma(r, A[4], A[3]), r2, _fma(r, A[2], A[1]))
    return _fma(r * r2, p, _fma(r2, A[0], lo)) + hi


def _glibc_log_near1(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``log`` of float64 ``x`` in [1 - 2^-4, 1 + 0x1.09p-4): a
    degree-11 polynomial in ``r = x - 1`` with ``r`` split at 2^27 for an
    exact ``-r^2 / 2``; every multiply-add is fused where ``__log_fma``
    has ``vfmadd`` (``x == 1`` gives +0 here too)."""
    B = LOG_B
    r = x - 1.0
    r2 = r * r
    r3 = r * r2
    p = _fma(r3, B[10], _fma(r2, B[9], _fma(r, B[8], B[7])))
    p = _fma(p, r3, _fma(r2, B[6], _fma(r, B[5], B[4])))
    p = _fma(p, r3, _fma(r2, B[3], _fma(r, B[2], B[1])))
    rhi = _fma(-r, LOG_SPLIT, _fma(r, LOG_SPLIT, r))      # r + w - w, both fused
    rlo = r - rhi
    rhi2 = rhi * rhi
    hi = _fma(rhi2, B[0], r)
    lo = _fma(rhi2, B[0], r - hi)
    lo = _fma(B[0] * rlo, rhi + r, lo)
    return hi + _fma(p, r3, lo)


def glibc_log_any(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``log`` of float64 ``x`` on every finite normal ``x > 0``:
    its near-1 polynomial where glibc takes it, :func:`glibc_log`
    elsewhere.  Plain PyTorch only (the Gumbel sampler's logs); the
    device ``libm.cuh`` has the main path alone."""
    d = _bits(x) - LOG_NEAR_LO
    near = (d >= 0) & (d < LOG_NEAR_SPAN)
    return torch.where(near, _glibc_log_near1(x), glibc_log(x))


def _sincos_lookup(ax: torch.Tensor):
    """``ax`` rounded to k / 128 (``big + ax``), its remainder, and the
    table's (sn, ssn, cs, ccs) at k (clamped: unselected branches also
    index the table)."""
    u = ax + SC_BIG
    xr = ax - (u - SC_BIG)
    k = (_bits(u) & 0xFFFFFFFF).clamp(max=109) * 4
    tab = _table("sincos", ax.device)
    return xr, tab[k], tab[k + 1], tab[k + 2], tab[k + 3]


def _taylor_sin(a, da):
    """TAYLOR_SIN(a^2, a, da): ``a + ((P(a^2) a - da / 2) a^2 + da)``."""
    xx = a * a
    poly = _horner(xx, SC_S[::-1])
    return a + _fma(xx, _fma(poly, a, -(0.5 * da)), da)


def _do_sin(a, da):
    """sin(a + da): the Taylor form below 0.126, else the table."""
    dx = torch.where(a <= 0, -da, da)
    xr, sn, ssn, cs, ccs = _sincos_lookup(a.abs())
    xx = xr * xr
    s = xr + _fma(xr * xx, _fma(xx, SC_SN5, SC_SN3), dx)
    c = _fma(xr, dx, xx * _horner(xx, (SC_CS6, SC_CS4, SC_CS2)))
    cor = _fma(s, cs, _fma(-c, sn, _fma(s, ccs, ssn)))
    table = torch.copysign(sn + cor, a)
    return torch.where(a.abs() < SC_TAYLOR, _taylor_sin(a, da), table)


def _do_cos(a, da):
    """cos(a + da) from the table."""
    dx = torch.where(a < 0, -da, da)
    xr, sn, ssn, cs, ccs = _sincos_lookup(a.abs())
    xr = xr + dx
    xx = xr * xr
    s = _fma(xr * xx, _fma(xx, SC_SN5, SC_SN3), xr)
    c = xx * _horner(xx, (SC_CS6, SC_CS4, SC_CS2))
    return cs + _fma(-s, sn, _fma(-c, cs, _fma(-s, ssn, ccs)))


def _reduce(x):
    """(n mod 4, a, da) with ``x = n pi / 2 + a + da``."""
    t = _fma(x, SC_HPINV, SC_TOINT)
    xn = t - SC_TOINT
    n = _bits(t) & 3
    y = _fma(-xn, SC_MP2, _fma(-xn, SC_MP1, x))
    t2 = _fma(-xn, SC_PP3, y)
    db = _fma(-xn, SC_PP3, y - t2)
    b = _fma(-xn, SC_PP4, t2)
    return n, b, db + _fma(-xn, SC_PP4, t2 - b)


def _quadrant(n, a, da):
    """do_sincos: sin(a + da) rotated by n quarter turns."""
    out = torch.where((n & 1) == 1, _do_cos(a, da), _do_sin(a, da))
    return torch.where((n & 2) == 2, -out, out)


def glibc_sin(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``sin`` of float64 ``x``.  Domain: ``|x| < 105414350``
    (beyond, glibc reduces with ``__branred``, which is not written)."""
    k = _high_word(x)
    zero = torch.zeros_like(x)
    small = _do_sin(x, zero)
    mid = torch.copysign(_do_cos(SC_HP0 - x.abs(), torch.full_like(x, SC_HP1)), x)
    big = _quadrant(*_reduce(x))
    out = torch.where(k < SC_MID, mid, big)
    out = torch.where(k < SC_SMALL, small, out)
    return torch.where(k < SIN_TINY, x, out)


def glibc_cos(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``cos`` of float64 ``x``.  Domain: ``|x| < 105414350``."""
    k = _high_word(x)
    small = _do_cos(x, torch.zeros_like(x))
    y = SC_HP0 - x.abs()
    a = y + SC_HP1
    mid = _do_sin(a, (y - a) + SC_HP1)
    n, a, da = _reduce(x)
    big = _quadrant(n + 1, a, da)
    out = torch.where(k < SC_MID, mid, big)
    out = torch.where(k < SC_SMALL, small, out)
    return torch.where(k < COS_TINY, torch.ones_like(x), out)
