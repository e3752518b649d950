"""Analytic bytes and operations of the port's kernel launches (the role
of the reference's ``repro.launch.hlocost``, which reads them off a
compiled HLO module; the port's programs are hand-written kernels, so
their costs are written down here, kernel by kernel).

Each function takes a launch's shapes and, where the work depends on the
data, the counts the run produced (chain steps, probes and merge steps,
live slots scanned, points drawn); left out, a count takes its largest
value for the shapes.  Bytes count each input read once and each output
written once; operations are of one kind (int32, fp32 or fp64), stated
against its own peak.  ``chip_smoke.py`` states every bound of
its kernels line from these functions and :data:`roofline.H100`, and
:func:`launch_cost` prices the launches a traced program made (the
registry of :mod:`repro_torch.analyze.programs`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

from .roofline import H100, THREEFRY_OPS, Peaks


@dataclass(frozen=True)
class Cost:
    """Bytes moved and operations of one launch (or a sum of launches of
    one operation kind)."""
    bytes: float
    ops: float = 0.0
    op_kind: str = "int32"

    def seconds(self, peaks: Peaks = H100) -> Tuple[float, float]:
        """``(bytes / bandwidth, ops / the kind's peak)``."""
        return self.bytes / peaks.bytes_per_s, self.ops / peaks.ops_per_s(self.op_kind)

    def bound_s(self, peaks: Peaks = H100) -> float:
        """The least time the card could take: the larger of the two."""
        return max(self.seconds(peaks))

    def bound_by(self, peaks: Peaks = H100) -> str:
        """``"bytes"`` or ``"operations"``: which term sets the bound."""
        b, o = self.seconds(peaks)
        return "bytes" if b >= o else "operations"

    def __add__(self, other: "Cost") -> "Cost":
        """The cost of both launches (of one operation kind, or none)."""
        if self.ops and other.ops and self.op_kind != other.op_kind:
            raise ValueError(f"cannot add {self.op_kind} and {other.op_kind} operations")
        kind = self.op_kind if self.ops else other.op_kind
        return Cost(self.bytes + other.bytes, self.ops + other.ops, kind)


ZERO = Cost(0.0)


# --------------------------------------------------------------------------
# the sampled families
# --------------------------------------------------------------------------

def chunk_sample(rows: int, capacity: int, drawn: Optional[int] = None) -> Cost:
    """The collision sampler over ``[rows, capacity]``: the sorted draws
    written once (8 bytes a slot), three Threefry blocks a drawn slot (the
    first round draws every slot; the 64-bit remainder is not counted, so
    the bound is a lower bound)."""
    slots = rows * capacity
    drawn = slots if drawn is None else drawn
    return Cost(slots * 8, drawn * 3 * THREEFRY_OPS)


def chunk_decode(rows: int, capacity: int) -> Cost:
    """Decode of ``[rows, capacity]`` sorted draws: each read once (8
    bytes), an edge (16) and a keep byte written."""
    return Cost(rows * capacity * (8 + 16 + 1))


def chunk_rmat(rows: int, capacity: int, log_n: int) -> Cost:
    """R-MAT rows: an edge and a keep byte a slot, ``2 + log_n`` Threefry
    blocks a slot (the edge's key, its fold and one a level)."""
    slots = rows * capacity
    return Cost(slots * 17, slots * (2 + log_n) * THREEFRY_OPS)


def chunk_ba(rows: int, capacity: int, steps: Optional[int] = None) -> Cost:
    """BA rows: an edge and a keep byte a slot, 6 Threefry blocks a chain
    step (``steps``: the run's walked steps, at least one a slot)."""
    slots = rows * capacity
    steps = slots if steps is None else steps
    return Cost(slots * 17, steps * 6 * THREEFRY_OPS)


def hist(ids: int, touched: int) -> Cost:
    """``ids`` int64 ids read once and ``touched`` counts read and
    written once (16 bytes each)."""
    return Cost(ids * 8 + touched * 16)


# --------------------------------------------------------------------------
# the geometric families
# --------------------------------------------------------------------------

def pair_mask(a_elems: int, b_elems: int, out_elems: int) -> Cost:
    """The euclid tile over ``[B, M, N]``: the float32 points read once,
    an int8 mask written; 6 float32 operations a pair (two differences,
    a product, an FMA, the compare)."""
    return Cost((a_elems + b_elems) * 4 + out_elems, out_elems * 6, "fp32")


def pair_mask_hyp(a_elems: int, b_elems: int, out_elems: int) -> Cost:
    """The hyp tile over ``[B, M, N]``: the float64 feature rows read
    once, an int8 mask written; 6 float64 operations a pair (two
    products, three FMAs, the compare)."""
    return Cost((a_elems + b_elems) * 8 + out_elems, out_elems * 6, "fp64")


def hyp_edges(rows_q: int, rows_c: int, pairs: int, hits: int) -> Cost:
    """The hyp test over ragged segments with the hits compacted: the
    float64 feature rows (32 bytes) and int64 gids (8) of both sides read
    once, an int64 pair (16 bytes) written a hit; 6 float64 operations a
    pair tested (two products, three FMAs, the compare)."""
    return Cost((rows_q + rows_c) * 40 + hits * 16, pairs * 6, "fp64")


def pair_edges(in_bytes: int, rows: int, capacity: int,
               points: Optional[int] = None) -> Cost:
    """Candidate-pair rows: the row tables read once (``in_bytes``), an
    edge and a keep byte a slot (``rows capacity^2``), and 5 Threefry
    blocks a point decoded (``points``: the rows' live counts, at most
    2 capacity a row; HYP features draw 2, TORUS points ``dim``, counted
    as the larger)."""
    points = 2 * rows * capacity if points is None else points
    return Cost(in_bytes + 17 * rows * capacity * capacity, points * 5 * THREEFRY_OPS)


def pair_edges_row_bytes(K: int, G: int, F: int) -> int:
    """Bytes of one candidate-pair row's tables: kind (4), two keys (8
    each), two counts (8 each), two gid vectors (8 K each), two geometry
    vectors (8 G each), fparams (8 F), self_pair and active (1 each)."""
    return 4 + 2 * 8 + 2 * 8 + 2 * 8 * K + 2 * 8 * G + 8 * F + 2


def cell_points(in_bytes: int, cells: int, capacity: int, dim: int,
                drawn: Optional[int] = None) -> Cost:
    """Point cells: the cell tables read once, ``8 dim + 1`` bytes a slot
    written (the point and its mask byte), ``1 + 2 dim`` Threefry blocks
    a drawn point (``drawn``: the cells' counts, at most ``capacity``)."""
    drawn = cells * capacity if drawn is None else drawn
    return Cost(in_bytes + cells * capacity * (8 * dim + 1),
                drawn * (1 + 2 * dim) * THREEFRY_OPS)


def triangulate(in_bytes: int, out_bytes: int, scanned: int, group: int, dim: int) -> Cost:
    """The batched triangulation: points and counts read, ``simp``,
    ``alive`` and ``ok`` written once; one in-sphere test a live slot
    scanned and candidate (``scanned``, counted by the kernel, times the
    group), each a ``dim``-term FMA dot (2 dim operations), the
    doubling, two adds and a compare."""
    return Cost(in_bytes + out_bytes, scanned * group * (2 * dim + 4), "fp64")


def circumspheres(simplices: int, dim: int) -> Cost:
    """Circumspheres of ``[R, d+1, d]`` simplices: each read once, the
    center, r^2 and the flag written; the determinants and the division
    about ``20 d^2`` operations a simplex."""
    return Cost(simplices * (dim + 1) * dim * 8 + simplices * (8 * dim + 9),
                simplices * 20 * dim * dim, "fp64")


# --------------------------------------------------------------------------
# clustering
# --------------------------------------------------------------------------

def close_wedges(mask_bytes: int, valid: int, table_bytes: int, samples: int,
                 hits_u: Optional[int] = None, steps: int = 0) -> Cost:
    """The edge-major wedge closer: the mask (or nothing) once, each
    valid edge once (16 bytes), the union table once, the counts written
    once.  Operations, the run's data: a probe of u a valid slot, a probe
    of v where u is in the union (``hits_u``), 8 integer operations a
    probe; a merge step (``steps``) 4."""
    hits_u = valid if hits_u is None else hits_u
    return Cost(mask_bytes + valid * 16 + table_bytes + samples * 8,
                (valid + hits_u) * 8 + steps * 4)


def close_wedges_pr16(mask_bytes: int, valid: int, samples: int, width: int,
                      live: int) -> Cost:
    """The bound of the row-major closer the edge-major one replaced: per
    live row and valid slot two binary searches of ``ceil(log2(width +
    1)) + 1`` steps of 4 operations, and the ``[S, width]`` table read
    once (printed beside the new bound for continuity)."""
    steps = math.ceil(math.log2(width + 1)) + 1
    return Cost(mask_bytes + valid * 16 + samples * width * 8 + samples * 8,
                live * valid * 2 * steps * 4)


# --------------------------------------------------------------------------
# the LM
# --------------------------------------------------------------------------

def lm_matmul_params(cfg) -> int:
    """Parameters a token multiplies through in the layers: the active
    parameters (``ArchConfig.active_param_count``) less the embedding
    table (a lookup), the head (counted apart: prefill takes logits at
    the last position only) and the norm scales (two a layer)."""
    return cfg.active_param_count() - 2 * cfg.vocab * cfg.d_model \
        - 2 * cfg.d_model * cfg.n_layers


_BF16 = 2  # bytes of a bfloat16 element: the LM's costs count bf16 weights and operations


def _attn_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def lm_prefill(cfg, batch: int, seq: int) -> Cost:
    """A prefill of ``batch`` prompts of ``seq`` tokens: 2 flops a matmul
    parameter a token, the head at each prompt's last position, and per
    attention layer the scores and the weighted values,
    ``4 B S^2 H hd`` halved by the causal mask; bytes: the bf16 weights
    and the prompts' embeddings read once, the KV cache written once.
    bfloat16 operations."""
    T = batch * seq
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    flops = (2 * lm_matmul_params(cfg) * T + 2 * cfg.d_model * cfg.vocab * batch
             + _attn_layers(cfg) * 2 * batch * seq * seq * H * hd)
    weights = (lm_matmul_params(cfg) + cfg.d_model * cfg.vocab) * _BF16
    kv = _attn_layers(cfg) * 2 * T * KV * hd * _BF16
    return Cost(weights + kv + T * cfg.d_model * _BF16, flops, "bf16")


def lm_decode(cfg, batch: int, context: int) -> Cost:
    """One greedy decode step of ``batch`` sequences whose new token
    attends to ``context`` positions: bytes, the bf16 weights (the
    layers' and the head) and the KV cache read once a step
    (``2 B context KV hd`` elements an attention layer); flops, 2 a
    matmul parameter and ``4 context H hd`` a layer, a sequence.
    bfloat16 operations."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    weights = (lm_matmul_params(cfg) + cfg.d_model * cfg.vocab) * _BF16
    kv = _attn_layers(cfg) * 2 * batch * context * KV * hd * _BF16
    flops = batch * (2 * lm_matmul_params(cfg) + 2 * cfg.d_model * cfg.vocab
                     + _attn_layers(cfg) * 4 * context * H * hd)
    return Cost(weights + kv, flops, "bf16")


def lm_train(cfg, batch: int, seq: int) -> Cost:
    """One training step on ``batch`` sequences of ``seq`` tokens, a floor
    that leaves the activations out.  Model flops (no recompute): 6 a
    matmul parameter a token, the head's at every position, and per
    attention layer ``12 seq H hd`` a token (scores and weighted values,
    forward and backward, the causal mask not halving them).  Bytes: the
    optimizer's seven float32 passes over every master (read ``p, g, m,
    v``; write ``p, m, v``), and the casts of the masters to bf16 (read 4,
    write 2 bytes): the layers' twice (forward and the remat recompute),
    the head's once.  bfloat16 operations."""
    T = batch * seq
    V, d = cfg.vocab, cfg.d_model
    flops = (6 * (lm_matmul_params(cfg) + d * V) * T
             + 12 * _attn_layers(cfg) * seq * cfg.n_heads * cfg.hd * T)
    layer_matrices = cfg.param_count() - 2 * V * d - 2 * d * cfg.n_layers
    casts = (2 * layer_matrices + d * V) * (4 + _BF16)
    return Cost(7 * 4 * cfg.param_count() + casts, flops, "bf16")


# --------------------------------------------------------------------------
# a traced program's launches
# --------------------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, "numel"))


def launch_cost(name: str, args: tuple, kwargs: dict) -> Cost:
    """The cost of one call of the kernel entry point ``name`` (one a
    registry program launches) from its arguments' shapes alone (the
    counts at their largest: nothing is read back from the card)."""
    kw = dict(kwargs)
    if name == "chunk_sample":
        return chunk_sample(args[0].shape[0], int(args[3] if len(args) > 3 else kw["capacity"]))
    if name == "chunk_decode":
        return chunk_decode(*args[0].shape)
    if name == "chunk_rmat":
        return chunk_rmat(args[1].shape[0], int(args[7]), int(args[6]))
    if name == "chunk_ba":
        return chunk_ba(args[1].shape[0], int(args[5]))
    if name == "pair_mask":
        a, b = args[0], args[1]
        M, N = a.shape[-2], b.shape[-2]
        B = a.shape[0] if a.dim() == 3 else 1
        return pair_mask(a.numel(), b.numel(), B * M * N)
    if name == "hyp_edges":
        # the pairs are the table's (a small read); every pair a hit at most
        seg = args[4].cpu()
        pairs = int((seg[:, 1] * seg[:, 3]).sum())
        return hyp_edges(args[0].shape[0], args[1].shape[0], pairs, pairs)
    if name == "pair_edges":
        rows, cap = args[0].shape[0], int(kw["capacity"])
        return pair_edges(_nbytes(*args), rows, cap)
    if name == "cell_points":
        cells, cap, dim = args[1].shape[0], int(kw["capacity"]), int(kw["dim"])
        return cell_points(_nbytes(*args), cells, cap, dim)
    if name == "triangulate":
        pts, cnt = args[0], args[1]
        B, N, d = pts.shape
        S = int(kw["num_simplices"])
        # every slot of every row scanned once a point: the shape's most
        return triangulate(_nbytes(pts, cnt), B * S * (4 * (d + 1) + 1) + B,
                           B * S * N, int(kw.get("group", 4)), d)
    raise KeyError(f"no cost for kernel {name!r}")
