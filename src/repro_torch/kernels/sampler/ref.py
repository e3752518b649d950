"""Plain PyTorch versions of the sampler kernels (same function, no kernel).

``sample_rows_ref`` (the collision sampler: ``chunk_draw_ref`` rounds and
``torch.sort``) computes what ``csrc/collision.cu`` computes;
``chunk_decode_ref``, ``chunk_rmat_ref`` and ``chunk_ba_ref`` what
``csrc/sampler.cu`` computes, element for element.  The CPU tests hold
them against ``repro.core`` (``sampling``, ``rmat._rmat_edges``,
``ba._resolve_targets``) and ``chip_smoke.py`` holds the kernels against
them on the card.  The decodes are the reference's ``decode_directed`` /
``decode_tri`` / ``decode_rect`` on int64 tensors.  ``row_buckets`` and
``barrett_mod64`` are the Python-integer twins of the kernels' bucket
choice and exact reciprocal reduction.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.prng import (bits64_limbs, fold_in, fold_in64, key_words, mod_u64, randint64,
                          uniform64)

KIND_EMPTY, KIND_DIRECTED, KIND_TRI, KIND_RECT, KIND_RMAT, KIND_BA = 0, 1, 2, 3, 4, 5

MAX_FIX_ROUNDS = 64     # the reference's _MAX_FIX_ROUNDS: redraw rounds 1..63
BUCKET_TARGET = 2048    # collision.cu's kTarget: n draws make ceil(n / 2048) buckets at most
BUCKET_CAP = 8192       # kTile: the largest bucket sorted in shared memory
LIST_CAP = 1024         # kListMax: duplicate positions listed per row


HIST_MAX = 8192         # kHistMax: buckets a row at most


def buckets_per_row(capacity: int) -> int:
    """Bucket counters a row of ``capacity`` slots needs (``nb_max``)."""
    return max(1, min(-(-int(capacity) // BUCKET_TARGET), HIST_MAX))


def row_buckets(universe: int, count: int, capacity: int):
    """(n, m, s, nb) of one row as ``collision.cu::row_plan`` takes them:
    ``n = min(max(count, 0), capacity)`` draws modulo ``m = max(universe,
    1)``; value ``v`` falls in bucket ``v >> s``, for the smallest ``s``
    that leaves ``nb <= min(ceil(n / BUCKET_TARGET), HIST_MAX)`` buckets
    (``nb = 0`` when ``n = 0``)."""
    n = min(max(int(count), 0), int(capacity))
    m = max(int(universe), 1)
    limit = min(-(-n // BUCKET_TARGET), HIST_MAX) if n else 1
    s = 0
    while (m - 1) >> s >= limit:
        s += 1
    return n, m, s, ((m - 1) >> s) + 1 if n else 0


def barrett_mod64(x: int, d: int):
    """(x mod d, x // d) for unsigned 64-bit ``x`` and ``1 <= d < 2^64``
    as ``threefry.cuh``'s ``mod64``/``div64`` compute them: the
    reciprocal ``floor((2^64 - 1) / d)``, its high product with ``x`` as
    the quotient's estimate, and two conditional corrections."""
    inv = (2 ** 64 - 1) // d
    q = (x * inv) >> 64
    r = (x - q * d) % 2 ** 64
    for _ in range(2):
        if r >= d:
            q, r = q + 1, r - d
    return r, q


def decode_directed(idx, n, row_lo):
    """Chunk-local universe index -> directed edge (u, v), u != v."""
    row = row_lo + idx // (n - 1)
    c = idx % (n - 1)
    col = c + (c >= row).to(idx.dtype)
    return row, col


def decode_rect(idx, width, row_lo, col_lo):
    """Rect chunk index -> undirected edge (u, v) with u > v."""
    return row_lo + idx // width, col_lo + idx % width


def _tri(k):
    return k * (k - 1) // 2


def decode_tri(idx, lo):
    """Strictly-lower-tri chunk index -> undirected edge (u, v), u > v.

    The float64 isqrt estimate is corrected in int64 (three steps, as the
    reference does), so it is exact up to idx ~ 2^62; the products wrap
    in int64 exactly as XLA's do."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    r = torch.floor((1.0 + torch.sqrt(1.0 + 8.0 * idx.to(torch.float64))) / 2.0
                    ).to(torch.int64)
    for _ in range(3):
        r = r - (_tri(r) > idx).to(torch.int64) + (_tri(r + 1) <= idx).to(torch.int64)
    return lo + r, lo + idx - _tri(r)


def chunk_draw_ref(key: torch.Tensor, universe: torch.Tensor,
                   count: torch.Tensor, t: int, capacity: int,
                   sorted_vals: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 ``[R, capacity]`` draws of round ``t`` for ``R`` chunk rows.

    Slot ``i`` of row ``r``: ``bits64(fold_in(fold_in(key_r, t), i)) mod
    max(U_r, 1)``, or the sentinel ``U_r + i`` for ``i >= count_r``.  In
    redraw mode (``sorted_vals`` given) sorted position ``p`` of an active
    row takes slot ``p``'s draw where it repeats its predecessor and keeps
    its value elsewhere."""
    k = fold_in(key_words(key), t)                              # [R, 2]
    idx = torch.arange(capacity, dtype=torch.int64, device=k.device)
    hi, lo = bits64_limbs(k[:, None, :], idx[None, :])          # [R, cap]
    u = universe[:, None]
    v = mod_u64(hi, lo, torch.clamp(u, min=1))
    v = torch.where(idx[None, :] < count[:, None], v, u + idx[None, :])
    if sorted_vals is None:
        return v
    dup = torch.zeros_like(sorted_vals, dtype=torch.bool)
    dup[:, 1:] = sorted_vals[:, 1:] == sorted_vals[:, :-1]
    return torch.where(dup & active[:, None], v, sorted_vals)


def sample_rows_ref(key: torch.Tensor, universe: torch.Tensor, count: torch.Tensor,
                    capacity: int, rounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sorted int64 ``[R, capacity]``: the reference's collision sampler
    over ``R`` rows.  Round 0 draws (:func:`chunk_draw_ref`) and sorts;
    round ``t = 1..63`` redraws each value equal to its sorted predecessor
    in the rows that have one and sorts again, until no row has one (the
    reference's vmapped ``while_loop``: a clean row is left as it is).
    ``rounds`` (int32 ``[R]``), when given, takes each row's redraw
    rounds.  Reads a flag on the host once a round."""
    s = torch.sort(chunk_draw_ref(key, universe, count, 0, capacity), dim=-1).values
    taken = torch.zeros(key.shape[0], dtype=torch.int32, device=s.device)
    for t in range(1, MAX_FIX_ROUNDS):
        active = (s[:, 1:] == s[:, :-1]).any(dim=1)
        if not bool(active.any()):
            break
        taken += active
        s = torch.sort(chunk_draw_ref(key, universe, count, t, capacity, s, active),
                       dim=-1).values
    if rounds is not None:
        rounds.copy_(taken)
    return s


def chunk_decode_ref(vals: torch.Tensor, kind: torch.Tensor,
                     params: torch.Tensor, count: torch.Tensor,
                     owned: torch.Tensor):
    """(edges int64 ``[R, cap, 2]``, keep bool ``[R, cap]``) of sorted
    draws ``vals`` ``[R, cap]``, decoded per row ``kind``.

    Rows of other kinds (EMPTY padding) decode to ``(0, 0)``.  A decode's
    divisor is 1 on the rows it does not select (and on degenerate rows,
    which hold no edge), so no row can divide by zero."""
    cap = vals.shape[1]
    kind = kind[:, None].to(torch.int64)
    p0, p1, p2 = (params[:, j:j + 1] for j in range(3))
    one = torch.ones_like(p0)
    zero = torch.zeros_like(vals)
    n = torch.where((kind == KIND_DIRECTED) & (p1 > 1), p1, one + one)
    du, dv = decode_directed(vals, n, p0)
    tu, tv = decode_tri(vals, p0)
    width = torch.clamp(torch.where(kind == KIND_RECT, p0, one), min=1)
    ru, rv = decode_rect(vals, width, p1, p2)
    u = torch.where(kind == KIND_DIRECTED, du,
                    torch.where(kind == KIND_TRI, tu,
                                torch.where(kind == KIND_RECT, ru, zero)))
    v = torch.where(kind == KIND_DIRECTED, dv,
                    torch.where(kind == KIND_TRI, tv,
                                torch.where(kind == KIND_RECT, rv, zero)))
    idx = torch.arange(cap, dtype=torch.int64, device=vals.device)
    keep = ((idx[None, :] < count[:, None]) & owned[:, None]
            & (kind != KIND_EMPTY))
    return torch.stack([u, v], dim=-1), keep


def _rows_out(out, R: int, capacity: int, device):
    """The output a per-kind chunk program writes: ``out`` (its own rows
    only), or fresh zeros (other rows stay ``(0, 0)``, not kept)."""
    if out is not None:
        return out
    return (torch.zeros((R, capacity, 2), dtype=torch.int64, device=device),
            torch.zeros((R, capacity), dtype=torch.bool, device=device))


def chunk_rmat_ref(key: torch.Tensor, kind: torch.Tensor, params: torch.Tensor,
                   fparams: torch.Tensor, count: torch.Tensor, owned: torch.Tensor,
                   log_n: int, capacity: int, out=None):
    """(edges int64 ``[R, capacity, 2]``, keep bool ``[R, capacity]``) of
    the RMAT rows: slot ``i`` is edge id ``params[1] + i``, whose key is
    ``fold_in64(key, id)``; each of ``log_n`` float64 uniforms picks a
    quadrant by ``a``, ``a + b``, ``a + b + c`` (``fparams``), giving one
    bit of source (quadrant >= 2) and destination (quadrant odd), most
    significant first.  Rows of other kinds are left as they are in
    ``out`` (or zeros, not kept)."""
    R = kind.shape[0]
    edges, keep = _rows_out(out, R, capacity, kind.device)
    idx = torch.arange(capacity, dtype=torch.int64, device=kind.device)
    k = fold_in64(key_words(key)[:, None, :], params[:, 1:2] + idx)     # [R, cap, 2]
    u = uniform64(k, (log_n,))                                          # [R, cap, log_n]
    a, b, c = (fparams[:, j, None, None] for j in range(3))
    ab = a + b
    quad = ((u >= a).to(torch.int64) + (u >= ab).to(torch.int64)
            + (u >= ab + c).to(torch.int64))
    bits = torch.arange(log_n - 1, -1, -1, dtype=torch.int64, device=kind.device)
    src = ((quad >= 2).to(torch.int64) << bits).sum(-1)
    dst = ((quad % 2) << bits).sum(-1)
    mine = (kind == KIND_RMAT)[:, None]
    edges.copy_(torch.where(mine[..., None], torch.stack([src, dst], dim=-1), edges))
    keep.copy_(torch.where(mine, (idx < count[:, None]) & owned[:, None], keep))
    return edges, keep


def chunk_ba_ref(key: torch.Tensor, kind: torch.Tensor, params: torch.Tensor,
                 count: torch.Tensor, owned: torch.Tensor, capacity: int, out=None,
                 steps: Optional[torch.Tensor] = None):
    """(edges, keep) of the BA rows: slot ``i`` is edge id ``e = params[1]
    + i`` of source ``e // d`` (``d = params[0]``); its target resolves
    the chain ``pos = 2e + 1``, ``pos <- randint(fold_in64(key, pos), 0,
    pos)`` while ``pos`` is odd, as ``(pos // 2) // d``.  When ``steps``
    (int64 ``[2]``) is given, the chain steps of every slot are added
    into ``steps[0]`` and 32 times the longest chain of each warp (32
    consecutive slots of a row, as the kernel's threads take them) into
    ``steps[1]``.  Rows of other kinds as in :func:`chunk_rmat_ref`."""
    R = kind.shape[0]
    edges, keep = _rows_out(out, R, capacity, kind.device)
    idx = torch.arange(capacity, dtype=torch.int64, device=kind.device)
    d = torch.clamp(params[:, :1], min=1)
    eid = params[:, 1:2] + idx
    mine = (kind == KIND_BA)[:, None]
    pos = torch.where(mine, 2 * eid + 1, 0).reshape(-1)
    kw = key_words(key)[:, None, :].expand(R, capacity, 2).reshape(-1, 2)
    live = torch.nonzero(pos & 1).reshape(-1)
    walked = torch.zeros_like(pos)
    while live.numel():
        p = pos[live]
        pos[live] = randint64(fold_in64(kw[live], p), 0, p)
        walked[live] += 1
        live = live[(pos[live] & 1) == 1]
    if steps is not None:
        steps[0] += walked.sum()
    tgt = (pos.reshape(R, capacity) // 2) // d
    edges.copy_(torch.where(mine[..., None], torch.stack([eid // d, tgt], dim=-1), edges))
    keep.copy_(torch.where(mine, (idx < count[:, None]) & owned[:, None], keep))
    return edges, keep
