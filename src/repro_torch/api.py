"""``GraphSpec -> plan -> run`` front door of the PyTorch/CUDA port (port
of ``repro.api``, all eight families).

1. **Spec**: :class:`GNM` / :class:`GNP` / :class:`RGG` / :class:`RHG` /
   :class:`RDG` / :class:`BA` / :class:`RMAT` / :class:`SBM`, frozen
   dataclasses carrying the seed and the model parameters
   (:class:`GraphSpec` is what each provides).
2. **Plan**: ``spec.plan(P, rng_impl=..., device=...)`` runs the host
   recursion and emits the ``[P, C]`` table (a ChunkPlan for G(n,m) /
   G(n,p), BA, R-MAT and SBM, a PairPlan of candidate cell pairs for RGG
   / RHG, of certified Delaunay simplices for RDG), equal field by field
   to the reference's;
   ``spec.point_plan(P)`` emits the geometric families' vertex cells.
   Only RDG's planning launches kernels (the triangulation and its
   certificates), on ``device``; the other families ignore it.
3. **Run / stream**: :func:`generate` executes the whole table and
   returns a :class:`Graph`; :func:`iter_edge_chunks` yields one row's
   fixed-capacity buffer at a time (or ``batch`` rows), and
   :func:`iter_points` streams vertex positions the same way.
   :func:`collect` measures degrees (and sampled clustering) while
   streaming, and :func:`validate` gates them against the family's
   closed-form law (:mod:`repro_torch.stats`).  ``iter_edge_chunks(...,
   overlap=k)`` plans in k PE-range segments on a background thread
   while earlier segments execute (:func:`plan_emitter`).
4. **Serve**: :func:`serve` / :func:`make_service` put many concurrent
   requests through one :class:`repro_torch.serve.Service` (plan cache
   with reseed, packed slabs of rows from many plans, per-request sinks).
5. **Check**: ``check=True`` (``generate``'s default, as the
   reference's) scans each program once for the communication-free
   contracts (:mod:`repro_torch.analyze`), and :func:`verify_contracts`
   reports them for one spec.
6. **Mesh**: ``mesh`` is the reference's mesh.  ``None`` is
   :func:`repro_torch.distrib.runtime.mesh_for` (the most local cards
   that divide P, as the reference's default) unless ``device`` names
   the CPU or one card.  A :class:`~repro_torch.distrib.world.LocalMesh`
   spreads PEs ``[d P/D, (d+1) P/D)`` over its row ``d``'s device: each
   row plans its slice, uploads it and runs on its card, and the results
   are the one-device run's, bit for bit (``generate`` gathers the rows'
   edges in PE order on ``device``, by default the mesh's first; the
   streams leave each chunk on the card of the row that streamed it,
   which under ``overlap`` is its segment's row, not its whole-plan row:
   :func:`repro_torch.distrib.runtime.stream_row`).  A row count D dividing P
   runs every row on the one card.  A :class:`~repro_torch.distrib.world.World`
   (``World.from_env()`` under ``torchrun``) makes the caller rank ``r``
   of ``size`` processes, each on k cards of its own: it plans, uploads
   and runs PEs ``[r P/size, (r+1) P/size)`` only, over its k rows (a
   :class:`~repro_torch.distrib.world.LocalMesh` of its cards), with no
   collective and no process group.  :func:`generate` returns the rank's
   edges in PE order, gathered on its first card, and concatenating the
   ranks' edges in rank order gives the one-process edges bit for bit;
   the streams yield the rank's chunks with global ``pe`` ids, each on
   its row's card.  :func:`collect` and :func:`validate` run on a
   :class:`~repro_torch.distrib.world.LocalMesh` (each row counts its
   chunks on its card, the partial counts are summed once), not on a world.

Every entry point takes ``device``: the work runs on CUDA unless the
caller passes ``device="cpu"`` (the plain PyTorch versions of the
kernels), and asking for CUDA without a GPU raises.  ``generate(spec,
P)`` gives the same edges, bit for bit, as ``repro.api.generate(spec,
P)``, for every P.

    >>> from repro_torch.api import GNM, generate
    >>> g = generate(GNM(n=1000, m=8000, seed=1), P=4, device="cpu")
    >>> g.m, g.n
    (8000, 1000)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Protocol, Tuple, runtime_checkable

import torch

from . import obs
from .core import ba as _ba
from .core import er as _er
from .core import graph as _graph
from .core import rdg as _rdg
from .core import rgg as _rgg
from .core import rhg as _rhg
from .core import rmat as _rmat
from .core import sbm as _sbm
from .core.prng import THREEFRY
from .distrib import engine, runtime
from .distrib.world import LocalMesh, World

DEFAULT_RNG = THREEFRY

# default virtual chunk-grid size: any P <= 16 generates the identical
# instance; larger machines grow the grid (chunks >= PEs)
DEFAULT_CHUNKS = 16


def _virtual_chunks(chunks: Optional[int], P: int) -> int:
    return chunks if chunks else max(P, DEFAULT_CHUNKS)


@dataclass(frozen=True)
class Graph:
    """Generated edge list plus the metadata needed to interpret it."""
    edges: torch.Tensor             # int64 [m, 2] on the run's device
    n: int
    directed: bool = False
    points: Optional[torch.Tensor] = None   # geometric families: float64 [n, dim]

    @property
    def m(self) -> int:
        return len(self.edges)

    def degrees(self) -> torch.Tensor:
        return _graph.degrees(self.edges, self.n, self.directed)


@dataclass(frozen=True)
class EdgeChunk:
    """One streamed chunk: a fixed-capacity device buffer + validity.

    ``mask`` is the validity (``[cap]``, or ``[b, cap]`` for batched
    buffers ``[b, cap, 2]``); ``count`` is the host-known number of valid
    edges of a ChunkPlan row, and ``None`` for a candidate-pair row,
    whose edges are only known once the device has tested them; ``pe``
    is the virtual PE that owns the chunk."""
    buffer: torch.Tensor            # int64 [cap, 2] / [b, cap, 2]
    mask: torch.Tensor              # bool [cap] / [b, cap]
    count: Optional[int]
    pe: int

    def edges(self) -> torch.Tensor:
        """The chunk's valid edges, on its device."""
        return self.buffer[self.mask]


@dataclass(frozen=True)
class PointChunk:
    """One streamed vertex cell (or ``batch`` cells): positions + validity
    + owner, the point analog of :class:`EdgeChunk`."""
    buffer: torch.Tensor            # float64 [cap, dim] / [b, cap, dim]
    mask: torch.Tensor              # bool [cap] / [b, cap]
    pe: int

    def points(self) -> torch.Tensor:
        """The chunk's valid positions, on its device."""
        return self.buffer[self.mask]


@runtime_checkable
class GraphSpec(Protocol):
    """What every family spec provides: parameters + a plan emitter."""
    seed: int

    @property
    def num_vertices(self) -> int: ...

    @property
    def directed(self) -> bool: ...

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None): ...


@dataclass(frozen=True)
class GNM:
    """Erdős-Rényi G(n, m): exactly m distinct edges (paper §4)."""
    n: int
    m: int
    directed: bool = False
    seed: int = 0
    chunks: Optional[int] = None

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        k = _virtual_chunks(self.chunks, P)
        f = _er.gnm_directed_plan if self.directed else _er.gnm_undirected_plan
        return engine.deal_plan(f(self.seed, self.n, self.m, k, rng_impl), P)


@dataclass(frozen=True)
class GNP:
    """Erdős-Rényi G(n, p): Bernoulli(p) per vertex pair (paper §4.3)."""
    n: int
    p: float
    directed: bool = False
    seed: int = 0
    chunks: Optional[int] = None

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        k = _virtual_chunks(self.chunks, P)
        f = _er.gnp_directed_plan if self.directed else _er.gnp_undirected_plan
        return engine.deal_plan(f(self.seed, self.n, self.p, k, rng_impl), P)


@dataclass(frozen=True)
class RGG:
    """Random geometric graph in [0,1)^dim: edge iff dist <= radius (§5)."""
    n: int
    radius: float
    dim: int = 2
    seed: int = 0
    chunks: Optional[int] = None
    directed: bool = False

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        return _rgg.rgg_pair_plan(self.seed, self.n, self.radius, P, self.dim,
                                  rng_impl, chunk_P=_virtual_chunks(self.chunks, P))

    def point_plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        """PointPlan over the same virtual cell grid the edge plan
        regenerates, so streamed positions match ``Graph.points``."""
        return _rgg.rgg_point_plan(self.seed, self.n, self.radius, P, self.dim,
                                   rng_impl, chunk_P=_virtual_chunks(self.chunks, P))


@dataclass(frozen=True)
class RHG:
    """Threshold random hyperbolic graph (paper §7), power-law exponent
    ``gamma``, target average degree ``avg_deg``."""
    n: int
    avg_deg: float
    gamma: float
    seed: int = 0
    directed: bool = False

    @property
    def num_vertices(self) -> int:
        return self.n

    @property
    def params(self) -> _rhg.RHGParams:
        return _rhg.RHGParams(n=self.n, avg_deg=self.avg_deg,
                              gamma=self.gamma, seed=self.seed)

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        return _rhg.rhg_pair_plan(self.params, P, rng_impl)

    def point_plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        """Polar PointPlan over the engine cell layout: the hashed streams
        the pair plan recomputes for its edge tests."""
        return _rhg.rhg_engine_point_plan(self.params, P, rng_impl)


@dataclass(frozen=True)
class RDG:
    """Random Delaunay graph on the unit torus [0,1)^dim (paper §6)."""
    n: int
    dim: int = 2
    seed: int = 0
    chunks: Optional[int] = None
    directed: bool = False

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        """The GEOM_CERT PairPlan; the halo protocol's triangulations and
        certificates run on ``device``."""
        return _rdg.rdg_pair_plan(self.seed, self.n, P, self.dim, rng_impl,
                                  chunk_P=self.chunks or 0,
                                  device=runtime.resolve_device(device))

    def plan_segment(self, P: int, lo: int, hi: int, *, rng_impl: str = DEFAULT_RNG,
                     device=None):
        """The plan rows of PEs [lo, hi) only: the device passes run once
        per seed (cached on the RDG planning structure), on ``device``,
        and each segment deals its slice of the rows."""
        return _rdg.rdg_plan_segment(self.seed, self.n, P, lo, hi, self.dim, rng_impl,
                                     chunk_P=self.chunks or 0,
                                     device=runtime.resolve_device(device))

    def point_plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        """PointPlan over the RDG cell grid (the grid the edge plan's
        triangulations draw their points from)."""
        return _rdg.rdg_point_plan(self.seed, self.n, P, self.dim, rng_impl,
                                   chunk_P=self.chunks or 0)


@dataclass(frozen=True)
class BA:
    """Barabási-Albert preferential attachment, d edges per vertex
    (Sanders-Schulz chain resolution, paper §3.5.1)."""
    n: int
    d: int
    seed: int = 0
    directed: bool = True

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        return _ba.ba_plan(self.seed, self.n, self.d, P, rng_impl)


@dataclass(frozen=True)
class RMAT:
    """R-MAT with 2^log_n vertices and m edges (Graph 500 semantics:
    self-loops and duplicates kept; paper §3.5.2)."""
    log_n: int
    m: int
    probs: Tuple[float, float, float, float] = (0.57, 0.19, 0.19, 0.05)
    seed: int = 0
    directed: bool = True

    @property
    def num_vertices(self) -> int:
        return 1 << self.log_n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        return _rmat.rmat_plan(self.seed, self.log_n, self.m, P, self.probs, rng_impl)


@dataclass(frozen=True)
class SBM:
    """Stochastic block model: ``blocks`` equal groups, within-block
    probability p_in, cross-block p_out (paper §Future-Work)."""
    n: int
    blocks: int
    p_in: float
    p_out: float
    seed: int = 0
    directed: bool = False

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG, device=None):
        return _sbm.sbm_plan(self.seed, self.n, self.blocks, self.p_in, self.p_out,
                             P, rng_impl)

    def plan_segment(self, P: int, lo: int, hi: int, *, rng_impl: str = DEFAULT_RNG,
                     device=None):
        """The plan rows of PEs [lo, hi) only, at about ``(hi - lo) / P`` of
        the plan's cost: what :func:`plan_emitter` hands to the runtime's
        plan/execute overlap."""
        return _sbm.sbm_plan_segment(self.seed, self.n, self.blocks, self.p_in,
                                     self.p_out, P, lo, hi, rng_impl)


def _all_points(spec, P: int, dev, rng_impl: str, check: bool, rows=1) -> torch.Tensor:
    """Every vertex position of a geometric spec in vertex-id order, on
    ``dev``: the point plan's cells run at once (a slice a row on a
    :class:`LocalMesh`) and scattered by their first id."""
    plan = spec.point_plan(P, rng_impl=rng_impl, device=dev)
    slot = torch.arange(plan.capacity, device=dev)
    out = torch.zeros((spec.num_vertices, plan.dim), dtype=torch.float64, device=dev)
    if isinstance(rows, LocalMesh):
        parts = runtime.run_rows(plan, rows, check)
    else:
        parts = [runtime.run(plan, dev, check=check, mesh=rows)]
    lo = 0
    for pts, mask in parts:
        hi = lo + len(mask)
        gid = torch.from_numpy(plan.gid0[lo:hi]).to(dev)[:, :, None] + slot
        mask = mask.to(dev)
        out[gid[mask]] = pts.to(dev)[mask]
        lo = hi
    return out


def _placed(mesh, P: int, device) -> Tuple[torch.device, int, int, object]:
    """``(device, lo, hi, rows)`` of an entry point on ``mesh``: a
    :class:`World` binds its rank's first device and gives the rank's PEs
    over its own rows (the row count 1 on a one-card rank, else the
    :class:`LocalMesh` of its cards); otherwise every PE, planned on
    ``device``, over the rows of :func:`runtime.placement`: a row count
    on ``device`` or a :class:`LocalMesh` of several rows."""
    if isinstance(mesh, World):
        dev = mesh.bind(device)
        lo, hi = mesh.pes(P)
        return dev, lo, hi, runtime.placement(hi - lo, mesh.local(), dev)[0]
    rows, dev = runtime.placement(P, mesh, device)
    return dev, 0, P, rows


def _plan_rows(spec, P: int, lo: int, hi: int, rng_impl: str, dev):
    """The plan of PEs ``[lo, hi)`` (the whole plan when that is every
    PE), as each rank of a world plans it: with :func:`plan_emitter`'s
    ``build``, equal field by field to rows ``[lo, hi)`` of the whole
    plan (``capacity`` apart, for families that plan a range natively)."""
    if (lo, hi) == (0, P):
        return spec.plan(P, rng_impl=rng_impl, device=dev)
    return plan_emitter(spec, P, rng_impl=rng_impl, device=dev).build(lo, hi)


def generate(spec, P: int = 1, *, device=None, mesh=None, rng_impl: str = DEFAULT_RNG,
             check: bool = True, return_points: bool = False) -> Graph:
    """Generate ``spec`` across P virtual PEs on ``device`` (CUDA unless
    ``"cpu"``); returns a :class:`Graph` whose edges are the
    reference's, in the reference's order.  ``return_points`` also
    fills ``Graph.points`` for the geometric families (RGG, RDG; RHG:
    polar ``(r, θ)``).

    ``check=True`` scans each distinct program once for the contracts of
    :mod:`repro_torch.analyze` (zero collectives first).  ``mesh`` is
    the reference's mesh (module docstring, item 6): ``None`` (every
    local card that divides P), a :class:`LocalMesh` (each row extracts
    its edges on its own card; they are gathered in PE order on
    ``device``, by default the mesh's first) or a row count D dividing P
    (all rows on the one card); the edges and their order do not depend
    on it.

    On a :class:`World` (``mesh=world``) the rank plans and runs only its
    PEs, each of its rows on its own card: ``edges`` are its PEs' edges in
    PE order, gathered on its first card (the ranks' in rank order
    concatenate to the one-process edges), and
    ``points`` its own cells' positions, cell by cell in stream order
    (what :func:`iter_points` yields on its rows), not all n."""
    dev, lo, hi, rows = _placed(mesh, P, device)
    plan = _plan_rows(spec, P, lo, hi, rng_impl, dev)
    if isinstance(rows, LocalMesh):
        parts = runtime.run_rows(plan, rows, check)
        with obs.trace("extract", phase="sink"):
            edges = [payload[valid] for payload, valid in parts]
            del parts
            edges = torch.cat([e.to(dev) for e in edges])
    else:
        payload, valid = runtime.run(plan, dev, check=check)
        with obs.trace("extract", phase="sink"):
            edges = payload[valid]
        del payload, valid
    points = None
    if return_points and hasattr(spec, "point_plan"):
        if isinstance(mesh, World):
            pts, ok = runtime.run(spec.point_plan(P, rng_impl=rng_impl, device=dev), dev,
                                  check=check, mesh=mesh)
            points = pts[ok]
        else:
            points = _all_points(spec, P, dev, rng_impl, check, rows)
    return Graph(edges=edges, n=spec.num_vertices, directed=spec.directed,
                 points=points)


def plan_emitter(spec, P: int = 1, *, segments: int = 0, rng_impl: str = DEFAULT_RNG,
                 device=None) -> runtime.PlanEmitter:
    """A lazily segmented plan of ``spec``: the input of the runtime's
    plan/execute overlap (:class:`repro_torch.distrib.runtime.PlanEmitter`).

    Families with ``plan_segment(P, lo, hi)`` (:class:`SBM`, :class:`RDG`)
    emit each PE range natively.  The others build the whole plan once,
    on the planner thread at its first segment, and cut it with
    ``slice_plan``: the same edges and order, planning merely moved off
    the consumer's thread.  ``segments=0`` takes the runtime's default.
    Planning runs on ``device`` (CUDA unless ``"cpu"``)."""
    dev = runtime.resolve_device(device)
    seg_fn = getattr(spec, "plan_segment", None)
    if seg_fn is not None:
        def build(lo: int, hi: int):
            return seg_fn(P, lo, hi, rng_impl=rng_impl, device=dev)
    else:
        state = {}

        def build(lo: int, hi: int):
            if "plan" not in state:
                state["plan"] = spec.plan(P, rng_impl=rng_impl, device=dev)
            return engine.slice_plan(state["plan"], lo, hi)

    return runtime.PlanEmitter(P, build, segments)


def verify_contracts(spec, P: int = 1, *, mesh=None, batch: int = 4, device=None,
                     raise_on_violation: bool = True):
    """Verify ``spec``'s communication-free contracts: run every program
    the spec emits (its edge plan and, for the geometric families, its
    point plan, through both :func:`runtime.run` and
    :func:`runtime.stream_waves`) under the op scan of
    :mod:`repro_torch.analyze` Pass 1 (zero collectives, no host reads,
    no draws from a ``torch.Generator``, static shapes), on tiny shapes
    of the plan's own tables.  The scan runs on ``device`` (CUDA unless
    ``"cpu"``; kernel entry points are opaque).  Returns the per-program
    :class:`~repro_torch.analyze.programs.ProgramReport`; raises
    ``AssertionError`` on any violation unless
    ``raise_on_violation=False``."""
    from .analyze import programs as _programs

    dev, _, _, rows = _placed(mesh, P, device)
    reports = _programs.scan_spec(spec, P, mesh=mesh if isinstance(mesh, World) else rows,
                                  batch=batch, device=dev, name=type(spec).__name__.lower())
    bad = [r for r in reports if not r.ok]
    if bad and raise_on_violation:
        lines = [f"{r.name}: " + (r.error or "; ".join(
            f.detail for f in r.scan.findings)) for r in bad]
        raise AssertionError("contract violations:\n  " + "\n  ".join(lines))
    return reports


def iter_edge_chunks(spec, P: int = 1, *, device=None, mesh=None,
                     rng_impl: str = DEFAULT_RNG, batch: int = 1,
                     prefetch: int = 2, overlap: int = 0,
                     check: bool = False) -> Iterator[EdgeChunk]:
    """Stream ``spec``'s edges as :class:`EdgeChunk` rows, pe-major.

    Grouping the chunks by ``pe`` and concatenating ``chunk.edges()``
    reproduces ``generate(spec, P).edges``; on one device the stream
    order is generate order.  ``batch > 1`` yields batched buffers.

    ``overlap > 0`` streams a plan emitted in that many PE-range segments
    (:func:`plan_emitter`) by a background planner thread while earlier
    segments' waves execute.  The chunks, their PEs and their order are
    the same; ``count`` is ``None`` (``mask`` stays authoritative), and an
    exception of the planner is raised here.

    ``mesh`` (a row count D dividing P) streams waves of D rows of
    ``batch`` slots; grouping by ``pe`` gives the same chunks.  On a
    :class:`LocalMesh` each wave's row ``d`` runs on row ``d``'s card,
    whose chunks stay there, the rows in order within a wave (the
    reference's order; a row count D streams the same chunks in the same
    order).  With ``overlap`` each segment is spread over all the rows,
    as in the reference, so a PE's row is its segment's
    (:func:`repro_torch.distrib.runtime.stream_row`).  On a :class:`World` the rank plans (in segments, with
    ``overlap``) and streams its own PEs only, over its own rows: rows
    ``[r k, (r+1) k)`` of the reference's wave schedule, with global
    ``pe`` ids.  ``check`` scans the wave program once, as
    :func:`generate` does."""
    dev, lo, hi, rows = _placed(mesh, P, device)
    shift = 0
    if overlap:
        plan = plan_emitter(spec, P, segments=int(overlap), rng_impl=rng_impl, device=dev)
        chunk_counts = None
        if isinstance(mesh, World):     # the runtime cuts the rank's segments
            rows = mesh
    else:
        plan = _plan_rows(spec, P, lo, hi, rng_impl, dev)
        chunk_counts = plan.count if isinstance(plan, engine.ChunkPlan) else None
        shift = lo                      # a rank's own PEs start at lo
    for pe, slots, payload, valid in runtime.stream_slots(
            plan, batch=batch, prefetch=prefetch, device=dev, mesh=rows, check=check):
        count = (int(chunk_counts[pe, slots].sum())
                 if chunk_counts is not None else None)
        pe = int(pe) + shift
        if batch <= 1:
            yield EdgeChunk(buffer=payload[0], mask=valid[0], count=count, pe=pe)
        else:
            yield EdgeChunk(buffer=payload, mask=valid, count=count, pe=pe)


def iter_points(spec, P: int = 1, *, device=None, mesh=None, rng_impl: str = DEFAULT_RNG,
                batch: int = 1, prefetch: int = 2, check: bool = False
                ) -> Iterator[PointChunk]:
    """Stream a geometric spec's vertex positions as :class:`PointChunk`
    cells, pe-major; grouping by ``pe`` and concatenating
    ``chunk.points()`` reproduces the masked output of its point plan.
    ``mesh`` and ``check`` as in :func:`iter_edge_chunks`; a
    :class:`World`'s rank streams its own cells."""
    point_plan = getattr(spec, "point_plan", None)
    if point_plan is None:
        raise TypeError(
            f"{type(spec).__name__} has no vertex positions to stream "
            f"(only the geometric families carry points)")
    dev, _, _, rows = _placed(mesh, P, device)
    plan = point_plan(P, rng_impl=rng_impl, device=dev)
    for pe, slots, payload, valid in runtime.stream_slots(
            plan, batch=batch, prefetch=prefetch, device=dev,
            mesh=mesh if isinstance(mesh, World) else rows, check=check):
        if batch <= 1:
            yield PointChunk(buffer=payload[0], mask=valid[0], pe=int(pe))
        else:
            yield PointChunk(buffer=payload, mask=valid, pe=int(pe))


def collect(spec, P: int = 1, **kwargs):
    """Streaming degree (and clustering) statistics of ``spec``:
    :func:`repro_torch.stats.collect` (re-export).  ``mesh=None`` (with no
    ``device``, or a CUDA device without an index) streams on
    :func:`repro_torch.distrib.runtime.mesh_for`'s cards, as the
    reference's ``collect`` does; each row counts its chunks on its card
    and the partial counts are summed once on ``device`` (the mesh's first
    by default).  A :class:`World` is refused."""
    from .stats import collect as _collect

    return _collect(spec, P, **kwargs)


def validate(spec, P: int = 1, **kwargs):
    """Goodness of fit of ``spec``'s output against its closed-form model
    law: :func:`repro_torch.stats.validate` (re-export), collected on
    ``mesh`` as :func:`collect` is."""
    from .stats import validate as _validate

    return _validate(spec, P, **kwargs)


def serve(specs, P: int = 1, **kwargs):
    """Serve many concurrent specs on the local cards: :func:`repro_torch.serve.serve`.

    The same graphs, bit for bit, as ``[generate(s, P) for s in specs]``,
    but plans resolve through a reseeding cache and the requests' rows
    pack into shared slabs.  Keyword arguments go to
    :class:`repro_torch.serve.Service`; use the class itself for
    streaming, admission at any time and latency metrics."""
    from .serve import serve as _serve

    return _serve(specs, P, **kwargs)


def make_service(P: int = 1, **kwargs):
    """A :class:`repro_torch.serve.Service` (lazy front door)."""
    from .serve import Service

    return Service(P, **kwargs)
