"""Per-vertex precompute and padding of the RHG feature rows (port of
the numpy half of ``repro.kernels.hypdist.ops``).

After the precompute ``[cos θ, sin θ, coth r, 1/sinh r]`` the adjacency
test dist_H(p, q) < R becomes the sign of a four-term inner product
(paper §7.2.1, Eq. 9): the ``hyp`` tile of
:func:`repro_torch.kernels.pairmask.ops.pair_mask`.  ``cosh_threshold``
lives in :mod:`repro_torch.core.rhg`.
"""
from __future__ import annotations

import numpy as np

FEAT = 8  # 4 features padded to sublane width

# padding rows: coth = +huge makes the Eq. 9 expression strongly negative
_PAD_ROW = np.array([0.0, 0.0, 1e30, 0.0, 0, 0, 0, 0])


def precompute_features(r: np.ndarray, theta: np.ndarray, dtype=np.float64) -> np.ndarray:
    """(N, 8): [cos θ, sin θ, coth r, 1/sinh r, 0...] (paper §7.2.1)."""
    r = np.maximum(np.asarray(r, np.float64), 1e-12)
    sh = np.sinh(r)
    out = np.zeros((len(r), FEAT), np.float64)
    out[:, 0] = np.cos(theta)
    out[:, 1] = np.sin(theta)
    out[:, 2] = np.cosh(r) / sh
    out[:, 3] = 1.0 / sh
    return out.astype(dtype)


def pad_features(feat: np.ndarray, rows: int | None = None, dtype=np.float64) -> np.ndarray:
    """``feat`` padded with :data:`_PAD_ROW` rows to ``rows`` (at least
    ``len(feat)``; by default ``len(feat)``) rounded up to a multiple of
    128, and to at least 128."""
    n = len(feat)
    rows = rows if rows is not None else (n + 127) // 128 * 128
    rows = max(128, (rows + 127) // 128 * 128)
    out = np.tile(_PAD_ROW, (rows, 1))
    out[:n] = feat
    return out.astype(dtype)
