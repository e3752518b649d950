"""Plain PyTorch version of the batched Bowyer-Watson triangulation (port
of ``repro.kernels.delaunay.ref``): the tests and the CPU path use it,
and the card holds the CUDA kernel (``csrc/delaunay.cu``) against it.

Each row triangulates one padded point set plus a super-simplex whose
``d+1`` vertices have ids ``N..N+d``.  A trip inserts a group of up to
``G`` candidates, the uninserted points at strided ranks: one in-sphere
scan of the slot table finds every candidate's cavity, candidates whose
cavities are disjoint (stage 1) and which lie outside the earlier
survivors' new circumspheres (stage 2) are accepted, and each survivor's
boundary facets become new simplices, in the killed slots first and then
past ``top``.  Any exact tie (``d2 == rr``, ``pw == wr2``), a degenerate
new simplex, or a capacity overflow clears the row's ``ok``.

The function follows ``ref.py:119-321`` of the reference step for step,
with its slot layout, so its ``simp``, ``alive`` and ``ok`` are the
reference's.  The reference ``vmap``s its while loop over rows; here all
active rows run each trip at once and finished rows stand still, which is
what the vmapped loop computes.

Arithmetic, as XLA on the CPU compiles the reference's loop (from the
compiled objects of ``delaunay_ref``):

* the slot scan ``d2 = |cc|^2 - 2 cc.p + |p|^2`` takes ``|cc|^2`` as
  ``(c0^2 + c1^2) (+ c2^2)`` with each product rounded (the vectorised
  loop multiplies before it shuffles, so nothing fuses), ``cc.p`` as the
  FMA chain ``fma(c1, p1, fma(c0, p0, 0))`` of the dot emitter, ``|p|^2``
  as an FMA chain, and ``d2 = (|cc|^2 - 2 cc.p) + |p|^2``.  (The scalar
  tail of that loop, the last few slots of each row, fuses ``|cc|^2``
  instead; those slots are never in use, see ROADMAP §3.)
* the super-simplex vertices are ``fma(512 * extent, unit, center)``;
* circumspheres and ``pw = |wctr - p|^2`` use the predicate of
  :mod:`.predicates` and an FMA chain.
"""
from __future__ import annotations

import math

import torch

from .predicates import circumsphere, fma, sum_squares

# super-simplex vertex directions, scaled by the row's extent
_R3 = math.sqrt(3.0)
SUPER_UNIT = {
    2: ((0.0, 2.0), (-_R3, -1.0), (_R3, -1.0)),
    3: ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0)),
}
SUPER_SCALE = 512.0
GROUP = 4


def boundary_capacity(cavity: int, dim: int) -> int:
    """Max boundary facets of a connected cavity of ``cavity`` simplices,
    the group-wide new-simplex budget ``W``."""
    return (dim - 1) * cavity + 2


def facet_index(dim: int) -> torch.Tensor:
    """int64 ``[d+1, d]``: facet ``k`` lists every vertex but ``k``."""
    return torch.tensor([[j + (j >= k) for j in range(dim)] for k in range(dim + 1)])


def super_simplex(pts: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """float64 ``[B, d+1, d]``: each row's bounding super-simplex."""
    B, N, d = pts.shape
    valid = (torch.arange(N, device=pts.device)[None, :] < cnt[:, None])[..., None]
    inf = torch.tensor(math.inf, dtype=pts.dtype, device=pts.device)
    lo = torch.where(valid, pts, inf).amin(dim=1)
    hi = torch.where(valid, pts, -inf).amax(dim=1)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    center = (lo + hi) * 0.5
    extent = (hi - lo).amax(dim=-1) * 0.5 + 1.0
    unit = torch.tensor(SUPER_UNIT[d], dtype=pts.dtype, device=pts.device)
    return fma((SUPER_SCALE * extent)[:, None, None], unit[None], center[:, None, :])


def _norm2(c: torch.Tensor) -> torch.Tensor:
    """``|c|^2`` of circumcenters ``[..., d]`` as the reference's slot scan
    rounds it: every product and sum rounded, no fusion."""
    s = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
    if c.shape[-1] == 3:
        s = s + c[..., 2] * c[..., 2]
    return s


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, ...]]`` for ``x [B, L, ...]`` and ``idx [B, ...]``."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    bi = torch.arange(B, device=x.device)[:, None].expand_as(flat)
    return x[bi, flat].reshape(*idx.shape, *x.shape[2:])


def triangulate_ref(pts: torch.Tensor, cnt: torch.Tensor, *, dim: int, num_simplices: int,
                    cavity: int, group: int = GROUP, work: torch.Tensor | None = None,
                    read_back: bool = True):
    """Triangulate ``B`` padded rows: ``pts`` float64 ``[B, N, d]`` (slots
    ``>= cnt`` ignored), ``cnt`` int ``[B]``.  Returns ``(simp [B, S, d+1]
    int32, alive [B, S] bool, ok [B] bool)``.  ``work``, an int64 ``[B,
    2]`` tensor, receives each row's trip count and the sum over its trips
    of the alive slots the trip scanned.

    Every trip runs on all rows with fixed shapes (a finished row's trip
    changes nothing), updates the state in place and reads nothing back.
    The host reads whether a row is still live once every trip on the
    CPU and every 16 trips on a card.  On the CPU it also
    reads the rows' largest ``top``, and the scan covers slots up to it
    plus what the trips before the next read can append; on a card every
    trip scans the whole slot table and is replayed from a captured CUDA
    graph (one trip is some 250 small launches, which the host would
    otherwise issue one by one).  ``read_back=False`` reads nothing: it
    runs ``N`` trips over the whole slot table, which finish every row,
    since a trip of a live row always inserts its first candidate."""
    B, N, d = pts.shape
    if d != dim or dim not in (2, 3):
        raise ValueError(f"points are {d}-dimensional, expected dim {dim} in (2, 3)")
    dev = pts.device
    # trips between two host reads (0: none)
    check_every = (1 if dev.type == "cpu" else 16) if read_back else 0
    S, CAV, G = num_simplices, cavity, group
    F, W, UC = CAV * (d + 1), boundary_capacity(CAV, d), 3 * CAV
    V = N + d + 1
    cnt = cnt.to(torch.int64)
    fidx = facet_index(d).to(dev)
    i64 = dict(dtype=torch.int64, device=dev)

    sup = super_simplex(pts, cnt)
    work_pts = torch.cat([pts, sup], dim=1)                      # [B, V, d]
    c0, r20, nd0 = circumsphere(sup)
    # W trash slots past S take the writes of the new simplices that get
    # no slot, and a trash column past N the insertions of no candidate
    vid = torch.zeros((B, S + W, d + 1), **i64)
    vid[:, 0] = torch.arange(d + 1, **i64) + N
    cc = torch.zeros((B, S + W, d), dtype=pts.dtype, device=dev)
    cc[:, 0] = c0
    ss = torch.zeros((B, S + W), dtype=pts.dtype, device=dev)   # |cc|^2 per slot
    ss[:, 0] = _norm2(c0)
    rr = torch.full((B, S + W), -math.inf, dtype=pts.dtype, device=dev)
    rr[:, 0] = torch.where(nd0, r20, math.inf)
    valid = torch.arange(N, device=dev)[None, :] < cnt[:, None]
    ins = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    nins = torch.zeros(B, **i64)
    top = torch.ones(B, **i64)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    trips = torch.zeros(B, **i64)
    scanned = torch.zeros(B, **i64)
    gi, ui = torch.arange(G, **i64), torch.arange(UC, **i64)
    ci, wi = torch.arange(CAV, **i64), torch.arange(W, **i64)
    offdiag = gi[:, None] != gi[None, :]
    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    # slots a trip may append: its first candidate's boundary facets (at
    # most F) and the budget W of the others
    grow = F + W

    def trip(T: int) -> None:
        live = nins < cnt
        a_cc, a_rr, a_ss = cc[:, :T], rr[:, :T], ss[:, :T]
        trips.add_(live)
        scanned.add_((a_rr > -math.inf).sum(dim=1) * live)

        # candidates: G uninserted points at strided ranks of the remainder
        icum = torch.cumsum((valid & ~ins[:, :N]).to(torch.int64), dim=1)
        rem = cnt - nins
        stride = torch.clamp(torch.div(rem, G, rounding_mode="floor"), min=1)
        ranks = gi[None, :] * stride[:, None]
        cand = torch.searchsorted(icum, ranks + 1)               # [B, G]
        cm = ranks < rem[:, None]
        p = _take(work_pts, cand.clamp(0, V - 1))                # [B, G, d]

        # one in-sphere scan of the slot table for the whole group
        dot = fma(a_cc[:, :, None, 0], p[:, None, :, 0], zero)
        for j in range(1, d):
            dot = fma(a_cc[:, :, None, j], p[:, None, :, j], dot)
        d2 = (a_ss[..., None] - dot * 2.0) + sum_squares(p)[:, None, :]
        bad = (d2 < a_rr[..., None]) & cm[:, None, :]          # [B, T, G]
        tie = (d2 == a_rr[..., None]) & cm[:, None, :]

        # the union cavity in ascending slot order, then each candidate's
        ucum = torch.cumsum(bad.any(dim=-1).to(torch.int64), dim=1)
        nu = ucum[:, -1]
        uni = torch.searchsorted(ucum, (ui + 1).expand(B, UC).contiguous())
        badu = _take(bad, uni.clamp(0, T - 1)) & (ui[None, :] < nu[:, None])[..., None]
        cumu = torch.cumsum(badu.to(torch.int64), dim=1)         # [B, UC, G]
        nb = cumu[:, -1]                                         # [B, G]
        locidx = torch.searchsorted(cumu.transpose(1, 2).contiguous(),
                                    (ci + 1).expand(B, G, CAV).contiguous())
        badidx = torch.where(locidx < UC, _take(uni, locidx.clamp(0, UC - 1)), S)
        cmask = ci[None, None, :] < nb[..., None]
        cav = _take(vid, badidx.clamp(0, S - 1))                 # [B, G, CAV, d+1]
        ffl = torch.sort(cav[..., fidx], dim=-1).values.reshape(B, G, F, d)
        fm = cmask[..., None].expand(B, G, CAV, d + 1).reshape(B, G, F)
        key = ffl[..., 0]
        for j in range(1, d):
            key = key * V + ffl[..., j]
        key = torch.where(fm, key, V ** d + torch.arange(F, **i64))
        sk = torch.sort(key, dim=-1).values
        left = torch.searchsorted(sk, key)
        nxt = torch.gather(sk, 2, (left + 1).clamp(0, F - 1))
        bnd = fm & torch.where(left + 1 < F, nxt != key, True)   # a facet seen once
        bcum = torch.cumsum(bnd.to(torch.int64), dim=2)
        nnew = bcum[..., -1]                                     # [B, G]

        # stage 1: disjoint cavities, within the new-simplex budget W
        ov = (badu[..., :, None] & badu[..., None, :]).any(dim=1)   # [B, G, G]
        accs = [cm[:, 0]]
        newsum = torch.where(cm[:, 0], nnew[:, 0], 0)
        for j in range(1, G):
            prev = torch.stack(accs, dim=1)
            take = (cm[:, j] & ~(prev & ov[:, :j, j]).any(dim=1)
                    & (newsum + nnew[:, j] <= W))
            accs.append(take)
            newsum = newsum + torch.where(take, nnew[:, j], 0)
        acc = torch.stack(accs, dim=1)

        # the survivors' boundary facets, compacted to W new simplices
        wcum = torch.cumsum((acc[..., None] & bnd).reshape(B, G * F).to(torch.int64), dim=1)
        nw = wcum[:, -1]
        wsel = torch.searchsorted(wcum, (wi + 1).expand(B, W).contiguous())
        wm = wi[None, :] < nw[:, None]
        wsafe = wsel.clamp(0, G * F - 1)
        wowner = torch.div(wsafe, F, rounding_mode="floor")
        lpos = torch.gather(bcum.reshape(B, G * F), 1, wsafe) - 1
        wf = _take(ffl.reshape(B, G * F, d), wsafe)              # [B, W, d]
        wnew = torch.cat([wf, torch.gather(cand, 1, wowner)[..., None]], dim=2)
        wctr, wr2, wnok = circumsphere(_take(work_pts, wnew))

        # stage 2: drop a survivor inside an earlier survivor's new sphere
        pw = sum_squares(wctr[:, :, None, :] - p[:, None, :, :])  # [B, W, G]
        oh = ((wowner[..., None] == gi) & wm[..., None])[..., :, None]    # owner one-hot
        hg = (oh & (pw < wr2[..., None])[..., None, :]).any(dim=1)        # [B, G, G]
        tg = (oh & (pw == wr2[..., None])[..., None, :]).any(dim=1)
        faccs = [acc[:, 0]]
        for j in range(1, G):
            prev = torch.stack(faccs, dim=1)
            faccs.append(acc[:, j] & ~(prev & hg[:, :j, j]).any(dim=1))
        facc = torch.stack(faccs, dim=1)

        # slots: a survivor reuses its killed slots, then appends past top;
        # a new simplex without a slot below S goes to its trash slot
        a = torch.where(facc, torch.clamp(nnew - nb, min=0), 0)
        aoff = torch.cumsum(a, dim=1) - a
        fmask = wm & torch.gather(facc, 1, wowner)
        nb_o = torch.gather(nb, 1, wowner)
        reuse = _take(badidx.reshape(B, G * CAV), wowner * CAV + lpos.clamp(0, CAV - 1))
        slots = torch.where(fmask, torch.where(lpos < nb_o, reuse,
                                               top[:, None] + torch.gather(aoff, 1, wowner)
                                               + lpos - nb_o), S)
        slots = torch.where(slots < S, slots, S + wi)
        killed = (bad & facc[:, None, :]).any(dim=-1)            # [B, T]
        rr[:, :T] = torch.where(killed, -math.inf, a_rr)
        vid.scatter_(1, slots[..., None].expand(B, W, d + 1), wnew)
        cc.scatter_(1, slots[..., None].expand(B, W, d), wctr)
        ss.scatter_(1, slots, _norm2(wctr))
        rr.scatter_(1, slots, torch.where(wnok, wr2, math.inf))
        new_top = top + a.sum(dim=1)
        hit = cm & (cand < N)
        ins.scatter_(1, torch.where(hit, cand, N), facc & hit)
        okc = ((nu <= UC)
               & torch.where(facc, (nb > 0) & (nb <= CAV) & (nnew <= W), True).all(dim=1)
               & ~tie.any(dim=(1, 2))
               & ~(fmask & ~wnok).any(dim=1)
               & ~(tg & facc[:, :, None] & facc[:, None, :] & offdiag).any(dim=(1, 2))
               & (new_top <= S))
        top.copy_(new_top)
        nins.add_(facc.sum(dim=1))
        ok.logical_and_(okc)

    graph, T, k = None, S, 0
    while True:
        if check_every and k % check_every == 0:
            if dev.type == "cpu":
                live_rows, most = torch.stack([(nins < cnt).sum(), top.max()]).tolist()
                # slots past top are dead (rr = -inf) and never bad: scan [0, T)
                T = min(most + check_every * grow, S)
            else:
                live_rows, T = int((nins < cnt).sum()), S
            if not live_rows:
                break
        elif not check_every and k == N:
            break
        k += 1
        if dev.type == "cpu":
            trip(T)
        elif graph is None:
            # the first trip runs as it is (on a side stream, as capture
            # wants), the next are replays of its capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                trip(S)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                trip(S)
        else:
            graph.replay()
    del graph

    if work is not None:
        work.copy_(torch.stack([trips, scanned], dim=1))
    return vid[:, :S].to(torch.int32), rr[:, :S] > -math.inf, ok
