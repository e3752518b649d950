"""Rows that exercise the triangulation's ``ok`` rules, shared by the CPU
parity tests (``test_torch_delaunay.py``) and the card tests
(``test_torch_cuda.py``); numpy and the port only, no JAX."""
import numpy as np
import torch

from repro_torch.kernels.delaunay.predicates import circumsphere
from repro_torch.kernels.delaunay.ref import _norm2


def tie_rows(dim, rows, seed):
    """Rows of d+2 points whose last point lies exactly on the circumsphere
    of the first d+1 under the slot scan's arithmetic: ``d2 = (|cc|^2 -
    2 cc.p) + |p|^2`` equals the squared radius ``rr`` bit for bit (the
    simplex the insertion of point d builds has its vertices in id
    order)."""
    rng = np.random.default_rng(seed)
    found = []
    steps = np.arange(-6, 7)
    while len(found) < rows:
        s = 0.3 + 0.4 * rng.random((dim + 1, dim))
        c, r2, nd = circumsphere(torch.from_numpy(s[None]))
        if not bool(nd[0]):
            continue
        c, rr = c[0].numpy(), float(r2[0])
        u = rng.normal(size=dim)
        p0 = c + np.sqrt(rr) * u / np.linalg.norm(u)
        grids = np.meshgrid(*[steps] * dim, indexing="ij")
        cand = np.stack([p0[k] + grids[k].ravel() * np.spacing(p0[k]) for k in range(dim)], 1)
        ct = torch.from_numpy(c)
        dot = ct[0] * torch.from_numpy(cand[:, 0])
        for k in range(1, dim):
            dot = torch.addcmul(dot, ct[k], torch.from_numpy(cand[:, k]))
        pt = torch.from_numpy(cand)
        sp = pt[:, 0] * pt[:, 0]
        for k in range(1, dim):
            sp = torch.addcmul(sp, pt[:, k], pt[:, k])
        d2 = ((_norm2(ct) - dot * 2.0) + sp).numpy()
        hit = np.nonzero(d2 == rr)[0]
        if len(hit):
            found.append(np.concatenate([s, cand[hit[:1]]]))
    return np.stack(found)


def overflow_row(dim, seed):
    """One row whose last point's cavity holds more simplices than the
    cavity capacity: ``k`` points (48 in 2-D, 100 in 3-D) near a sphere (radii 1 +- 1e-3, no
    exact ties), inserted first, then its centre, whose cavity is every
    simplex of the ring's triangulation."""
    rng = np.random.default_rng(seed)
    k = 48 if dim == 2 else 100
    u = rng.normal(size=(k, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    ring = 0.5 + 0.3 * u * (1 + 1e-3 * rng.uniform(-1, 1, (k, 1)))
    return np.concatenate([ring, np.full((1, dim), 0.5)])
