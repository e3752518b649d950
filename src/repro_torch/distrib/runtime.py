"""Executor for the port's plans on one device, or on each rank of a
world (port of the run and wave-streaming half of
``repro.distrib.runtime``).

A plan exposes ``input_arrays()`` (its ``[P, C, ...]`` numpy tables),
``slot_fn()`` (the batched program over ``[R]`` table rows) and
``stream_index()`` (``[K, 2]`` of ``(pe, slot)`` for every row that
contributes output, pe-major).  On that:

* :func:`run` executes the whole ``[P, C]`` table as one batch of rows
  (one launch set) and returns ``(payload [P, C, ...], valid [P, C,
  L])``; ``valid`` folds in validity and ownership, so boolean
  extraction of ``payload`` by ``valid`` is the exact global output.
* :func:`stream_waves` executes the plan's owned rows as ``[D=1,
  batch]`` slabs, in stream order; a batch never straddles a PE, so
  grouping the streamed rows by PE reproduces :func:`run`'s output.
  ``prefetch`` bounds how many executed waves are held before the
  consumer takes them.  No kernel of a wave reads anything back to the
  host (the sampler runs its redraw rounds on the card), so the host
  queues wave k+1 while the card still runs wave k.
* :class:`PlanEmitter` streams a plan emitted one PE-range segment at a
  time: a background planner thread builds segment k+1 while segment
  k's waves execute (plan/execute overlap), and the regrouped stream is
  the unsegmented plan's.
* :func:`run_slab` executes one packed ``[D, B]`` slab of rows that the
  serving scheduler (:mod:`repro_torch.serve`) assembled from many plans
  sharing one slot function.

``check=True`` scans each slot-function cache entry **once**, on its
first checked call: that execution runs under the op trace of
:mod:`repro_torch.analyze.opscan`, and a collective raises
``assert_communication_free``'s error, any other violation of the
generator contract (every program kind's in the port) an
``AssertionError`` naming the rule.  An entry that
fails is scanned again on its next checked call (the reference's
``_Entry.checked``).

``mesh`` is the reference's mesh.  ``None`` is :func:`mesh_for` (the
reference's default: a :class:`~repro_torch.distrib.world.LocalMesh`
over the most local cards that divide P), unless ``device`` names the
CPU or an indexed card, which gives one row on it.  A
:class:`~repro_torch.distrib.world.LocalMesh` of several rows runs row
``d``'s PEs ``[d P/D, (d+1) P/D)`` on its own device (and stream):
:func:`run` slices the plan a row, :func:`stream_waves` executes row
``d`` of each wave of the reference's schedule there, and
:func:`run_slab` uploads each row of a slab to its own device.  A
one-row mesh is the one-card path exactly.  A row count ``D`` deals a
plan's PEs onto ``D`` rows of each wave, all on the one card, in one
launch; it must divide P.  A
:class:`~repro_torch.distrib.world.World` makes the caller rank r of a
world, a process on k cards of its own: :func:`run` and
:func:`stream_waves` slice the plan to the rank's PEs ``[r P/size, (r+1)
P/size)``, run the slice on the rank's own mesh (:meth:`World.local`: a
:class:`~repro_torch.distrib.world.LocalMesh` of its k cards, the one
card when k = 1) and shift the PEs and mesh rows to the world's, so
that the rank yields rows ``[r k, (r+1) k)`` of the reference's
``size k``-row schedule.

There are no collectives: each process executes its own PEs' rows and
waits on no other.
There is no compile either: a plan's slot function is a closure over
its static parameters, cached by the plan's ``signature()`` (the stand-in
for the reference's compile cache, whose hits and misses the
``compile_cache`` events report).  The reference's spans (``run/exec``,
``wave/*``, ``slab/exec``, ``plan/overlap``) are opened here; while
tracing is on, ``run/exec``, ``wave/device`` and ``slab/exec`` end in a
``torch.cuda.synchronize``, so device time lands in them.
"""
from __future__ import annotations

import functools
import queue as _queue
import threading
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..analyze import opscan
from ..kernels.build import resolve_device
from .world import LocalMesh, World, check_rows


def plan_tensors(plan, device) -> Tuple[torch.Tensor, ...]:
    """The plan's tables as tensors on ``device`` (uint32 tables as int32
    tensors holding the same bits)."""
    out = []
    for a in plan.input_arrays():
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


# slot functions by (path, signature, ...): see the module docstring
_CACHE: Dict[tuple, Callable] = {}
# the cache keys whose entry passed its contract scan
_CHECKED: set = set()


def cache_clear() -> None:
    _CACHE.clear()
    _CHECKED.clear()
    mesh_for.cache_clear()


def mesh_size(mesh) -> int:
    """The row count of a mesh: a :class:`LocalMesh`'s devices, a
    :class:`World`'s ``size k`` rows, or a row count itself (``None``: 1)."""
    if isinstance(mesh, World):
        return mesh.size * mesh.cards
    if isinstance(mesh, LocalMesh):
        return mesh.size
    return 1 if mesh is None else int(mesh)


@functools.lru_cache(maxsize=None)
def mesh_for(P: int) -> LocalMesh:
    """The cached default mesh for P virtual PEs: the most local cards
    that divide P (:func:`repro_torch.distrib.engine.default_mesh`)."""
    from .engine import default_mesh

    return default_mesh(P)


def placement(P: int, mesh=None, device=None):
    """``(rows, device)`` of an entry point: ``rows`` is a row count D
    (every row on ``device``, which is resolved) or a :class:`LocalMesh`
    of its rows' devices, and ``device`` is where planning runs and
    gathered results land (a mesh's first device unless ``device`` names
    one).  ``mesh=None`` is :func:`mesh_for` unless ``device`` is the CPU
    or an indexed card (one row there); a one-row mesh whose device is
    ``device`` is the row count 1.  Raises unless the rows divide P."""
    if mesh is None:
        explicit = device is not None and (torch.device(device).type == "cpu"
                                           or torch.device(device).index is not None)
        mesh = LocalMesh((device,)) if explicit else mesh_for(P)
    if isinstance(mesh, LocalMesh):
        check_rows(P, mesh.size)
        dev = mesh.devices[0] if device is None else resolve_device(device)
        if mesh.size == 1 and mesh.devices[0] == dev:
            return 1, dev
        return mesh, dev
    D = int(mesh)
    check_rows(P, D)
    return D, resolve_device(device)


def _slot_fn(kind: str, key: tuple, thunk: Callable[[], Callable]) -> Callable:
    """The cached slot function of ``key``; ``thunk`` builds it on a miss."""
    fn = _CACHE.get(key)
    obs.event("compile_cache", kind=kind, hit=fn is not None)
    if fn is None:
        fn = _CACHE[key] = thunk()
    return fn


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _checked(key: tuple, check: bool, step: Callable):
    """``step()``, under the op scan when ``check`` asks for it and the
    cache entry ``key`` has not passed its scan yet (every program kind's
    contract is the generator contract in the port)."""
    if not check or key in _CHECKED:
        return step()
    with opscan.trace() as census:
        out = step()
    opscan.assert_contract(census, opscan.GENERATOR_CONTRACT, f"{key[0]} program {key[1]}")
    _CHECKED.add(key)
    return out


def _row_key(key: tuple, mesh: LocalMesh, d: int) -> tuple:
    """The contract-scan key of row ``d`` of a local mesh: each row's
    program is scanned once, on its own device."""
    return key + ("row", d, str(mesh.devices[d]))


def run_rows(plan, mesh: LocalMesh, check: bool = True, only=None) -> list:
    """Execute a plan's table on a :class:`LocalMesh`: row ``d`` slices
    the plan to its PEs, uploads its tables to its device and runs them
    there, in one program call under its stream.  Returns a list of
    ``(payload [P/D, C, ...], valid [P/D, C, L])`` a row, each on its
    row's device and handed over to the caller's current stream there
    (``None`` for a row left out of ``only``).  Every row is launched
    before any is read back, so rows on distinct cards run at once."""
    from .engine import slice_plan

    P = plan.num_pes
    check_rows(P, mesh.size)
    key = ("run", plan.signature())
    fn = _slot_fn("run", key, plan.slot_fn)
    out, fences = [None] * mesh.size, [None] * mesh.size
    for d in (range(mesh.size) if only is None else only):
        part = slice_plan(plan, *mesh.pes(P, d))
        with mesh.row(d) as dev, obs.trace("run/exec", phase="exec", mode="run", row=d):
            tables = plan_tensors(part, dev)
            R, C = tables[0].shape[:2]
            rows = [t.reshape(R * C, *t.shape[2:]) for t in tables]
            payload, valid = _checked(_row_key(key, mesh, d), check, lambda: fn(*rows))
            out[d] = (payload.reshape(R, C, *payload.shape[1:]),
                      valid.reshape(R, C, *valid.shape[1:]))
            fences[d] = mesh.fence(d)
            if obs.is_enabled():
                _sync(dev)
    for d, res in enumerate(out):
        if res is not None:
            mesh.hand_over(d, fences[d], res)
    return out


def run(plan, device=None, check: bool = True, mesh=None):
    """Execute a plan's full table; returns ``(payload, valid)``.

    ``mesh`` is ``None`` (:func:`placement`), a row count D dividing P
    (every row on the one card; the output does not depend on it), a
    :class:`LocalMesh` (each row's PEs on its device, :func:`run_rows`;
    the rows' outputs concatenated on ``device``, by default the mesh's
    first) or a :class:`World`: its rank runs only its own PEs' slice, on
    its own rows, and gets its shard ``[P/size, C, ...]`` of the payload,
    gathered on its first device."""
    if isinstance(mesh, World):
        part, _ = _rank_part(plan, mesh)
        return run(part, mesh.bind(device), check, mesh.local())
    rows, dev = placement(plan.num_pes, mesh, device)
    if isinstance(rows, LocalMesh):
        parts = run_rows(plan, rows, check)
        return tuple(torch.cat([part[i].to(dev) for part in parts]) for i in (0, 1))
    key = ("run", plan.signature())
    fn = _slot_fn("run", key, plan.slot_fn)
    tables = plan_tensors(plan, dev)
    P, C = tables[0].shape[:2]      # every plan kind's tables are [P, C, ...]
    rows = [t.reshape(P * C, *t.shape[2:]) for t in tables]
    with obs.trace("run/exec", phase="exec", mode="run"):
        payload, valid = _checked(key, check, lambda: fn(*rows))
        if obs.is_enabled():
            _sync(dev)
    return (payload.reshape(P, C, *payload.shape[1:]),
            valid.reshape(P, C, *valid.shape[1:]))


@dataclass(frozen=True)
class WaveSchedule:
    """Host-side dealing of a plan's stream index onto mesh rows.

    ``sched[w, d, b] = (local_pe, slot)`` addresses row ``b`` of wave
    ``w`` on mesh row ``d``; ``valid`` masks ragged padding rows;
    ``rows[w][d]`` is ``(pe, slots)`` or ``None`` for an all-padding
    row.  Batches never straddle a PE boundary."""
    sched: np.ndarray       # int32 [W, D, B, 2] (local pe, slot)
    valid: np.ndarray       # bool  [W, D, B]
    rows: tuple             # [W][D] -> (pe, slots np.ndarray) | None
    batch: int              # B, clamped to the longest per-PE run

    @property
    def num_waves(self) -> int:
        return self.sched.shape[0]


def wave_schedule(plan, D: int = 1, batch: int = 1) -> WaveSchedule:
    """Deal the plan's owned rows into waves of ``batch`` rows per mesh
    row (the reference's schedule)."""
    index = np.asarray(plan.stream_index())
    P = plan.num_pes
    check_rows(P, D)
    ppd = P // D
    starts = np.searchsorted(index[:, 0], np.arange(P + 1))
    per_pe = [index[starts[pe]: starts[pe + 1], 1] for pe in range(P)]
    B = max(1, min(int(batch), max((len(s) for s in per_pe), default=1)))
    dealt: list = [[] for _ in range(D)]
    for pe, slots in enumerate(per_pe):
        for s in range(0, len(slots), B):
            dealt[pe // ppd].append((pe, slots[s: s + B]))
    W = max((len(b) for b in dealt), default=0)
    sched = np.zeros((W, D, B, 2), np.int32)
    valid = np.zeros((W, D, B), bool)
    rows = [[None] * D for _ in range(W)]
    for d, batches in enumerate(dealt):
        for w, (pe, slots) in enumerate(batches):
            k = len(slots)
            sched[w, d, :k, 0] = pe - d * ppd
            sched[w, d, :k, 1] = slots
            valid[w, d, :k] = True
            rows[w][d] = (pe, np.asarray(slots))
    return WaveSchedule(sched, valid, tuple(tuple(r) for r in rows), B)


@dataclass(frozen=True)
class Wave:
    """One executed ``[D, batch]`` slab on the device: ``payload[d]`` /
    ``valid[d]`` are mesh row ``d``'s batch of outputs with the padding
    masked; ``rows[d]`` names its PE and slot ids.

    On a :class:`LocalMesh` of several rows ``payload`` and ``valid`` are
    tuples of D ``[B, ...]`` tensors, each on its row's device (``None``
    for a row with no batch in the wave).  A rank of a :class:`World`
    holds its own k rows only: ``payload`` and ``valid`` are ``[1, B,
    ...]`` on a one-card rank and a tuple of k rows' on a rank of k cards,
    ``row0`` is the rank's first row ``r k``, and ``rows`` is ``None`` at
    every other rank's rows."""
    payload: object         # [D, B, ...] ([1, B, ...] on a world; a tuple of rows)
    valid: object           # [D, B, L]
    rows: tuple             # [D] -> (pe, slots) | None
    row0: int = 0           # the mesh row of payload[0]

    def chunks(self) -> Iterator[Tuple[int, np.ndarray, torch.Tensor, torch.Tensor]]:
        """Yield ``(pe, slots, payload [B, ...], valid [B, L])`` per
        non-empty mesh row (ragged tails are masked, not trimmed)."""
        for d, row in enumerate(self.rows):
            if row is None:
                continue
            pe, slots = row
            yield pe, slots, self.payload[d - self.row0], self.valid[d - self.row0]


# --------------------------------------------------------------------------
# lazily segmented plans: plan/execute overlap
# --------------------------------------------------------------------------

#: default number of plan segments when the emitter does not pin one
DEFAULT_SEGMENTS = 4


class PlanEmitter:
    """A plan emitted lazily, one PE-range segment at a time.

    ``build(lo, hi)`` returns a plan holding exactly the rows of global
    PEs ``[lo, hi)`` re-indexed to ``[0, hi - lo)``: for table plans,
    field by field equal to :func:`repro_torch.distrib.engine.slice_plan`
    of the full emission, except that the segment's ``capacity`` may be
    segment-local (each slot's draws do not depend on the capacity, so
    the outputs are the same).  Families whose per-PE rows are cheap to
    restrict build natively; :meth:`from_plan` wraps a built plan.

    Segment widths are multiples of the mesh row count D; segments come
    in ascending PE order and each keeps its per-PE stream order, so the
    overlapped stream regroups to the unsegmented plan's per-PE order.
    """

    def __init__(self, num_pes: int, build: Callable[[int, int], object],
                 segments: int = 0):
        self.num_pes = int(num_pes)
        self.build = build
        self.segments = int(segments)

    @classmethod
    def from_plan(cls, plan, segments: int = 0) -> "PlanEmitter":
        """Segment an already-built table plan through ``slice_plan``."""
        from .engine import slice_plan

        return cls(plan.num_pes, lambda lo, hi: slice_plan(plan, lo, hi), segments)

    def segment_bounds(self, D: int = 1) -> Tuple[Tuple[int, int], ...]:
        """The (lo, hi) PE ranges streamed over a D-row mesh: about equal
        widths, every width a multiple of D, ascending."""
        if self.num_pes % D:
            raise ValueError(
                f"mesh of {D} devices cannot shard a {self.num_pes}-PE "
                f"emitter: P % devices must be 0")
        nb = self.num_pes // D
        k = max(1, min(self.segments or DEFAULT_SEGMENTS, nb))
        cuts = [nb * s // k * D for s in range(k + 1)]
        return tuple((cuts[s], cuts[s + 1]) for s in range(k)
                     if cuts[s + 1] > cuts[s])


def stream_row(P: int, D: int, pe: int, overlap: int = 0) -> int:
    """The mesh row of D that streams PE ``pe`` of a P-PE plan, as in the
    reference: row ``D pe / P`` of the whole plan, or with ``overlap``
    segments row ``D (pe - lo) / (hi - lo)`` of the segment ``[lo, hi)``
    that holds ``pe``, since every segment is spread over all D rows.  On
    a :class:`LocalMesh` a chunk of ``pe`` lies on that row's device."""
    check_rows(P, D)
    if not overlap:
        return D * pe // P
    for lo, hi in PlanEmitter(P, None, overlap).segment_bounds(D):
        if lo <= pe < hi:
            return D * (pe - lo) // (hi - lo)
    raise ValueError(f"PE {pe} is not one of the plan's {P}")


def _plan_feed(emitter: PlanEmitter, device: torch.device, D: int = 1):
    """Start the background planner: it builds the segments in PE order
    into a bounded queue (at most two segments ahead of execution), each
    in a ``plan/overlap`` span on the planner's thread.
    Items are ``(lo, plan)``, then ``None`` at exhaustion; an exception of
    the planner is put on the queue for the consumer to raise.  Returns
    ``(queue, stop)``: setting ``stop`` ends the planner at its next
    segment or queue wait, so an abandoned stream does not leave it
    running.

    The thread runs on ``device`` (PyTorch's current device is per
    thread); its launches (RDG's triangulation on a cold seed) go on that
    device's current stream, which is the default stream in a new
    thread, and every segment it hands over is host numpy, copied from
    the device before the hand-off."""
    q: _queue.Queue = _queue.Queue(maxsize=2)
    stop = threading.Event()
    bounds = emitter.segment_bounds(D)
    # made here, so a device without an index is the consumer's current one
    guard = torch.cuda.device(device) if device.type == "cuda" else nullcontext()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                pass
        return False

    def planner() -> None:
        try:
            with guard:
                for i, (lo, hi) in enumerate(bounds):
                    if stop.is_set():
                        return
                    with obs.trace("plan/overlap", phase="plan", segment=i,
                                   segments=len(bounds), lo=lo, hi=hi):
                        seg = emitter.build(lo, hi)
                    if not put((lo, seg)):
                        return
            put(None)
        except BaseException as e:  # forwarded to the consumer thread
            put(e)

    threading.Thread(target=planner, name="repro-torch-plan-emitter", daemon=True).start()
    return q, stop


def _shifted(wave: Wave, lo: int, row0: int = 0, D: int = 0) -> Wave:
    """``wave`` with its PEs moved up by ``lo`` and its rows placed at
    ``[row0, row0 + len(wave.rows))`` of ``D`` mesh rows (its own row
    count when ``D`` is 0)."""
    rows = [None] * (D or len(wave.rows))
    for j, r in enumerate(wave.rows):
        rows[row0 + j] = None if r is None else (r[0] + lo, r[1])
    return Wave(wave.payload, wave.valid, tuple(rows), row0 + wave.row0)


def _rank_part(plan, world: World):
    """``(part, lo)``: the rank's slice of ``plan`` (a table plan, or a
    :class:`PlanEmitter` restricted to the rank's PE range), re-indexed
    from its first PE ``lo``."""
    lo, hi = world.pes(plan.num_pes)
    if isinstance(plan, PlanEmitter):
        return PlanEmitter(hi - lo, lambda a, b: plan.build(lo + a, lo + b), plan.segments), lo
    from .engine import slice_plan
    return slice_plan(plan, lo, hi), lo


def _stream_emitter_waves(emitter: PlanEmitter, mesh, batch: int, prefetch: int,
                          device: torch.device, check: bool) -> Iterator[Wave]:
    """:func:`stream_waves` over a lazily segmented plan: execute segment
    k's waves while the planner thread emits segment k+1 (on ``device``),
    each segment over the ``mesh`` rows (a row count or a
    :class:`LocalMesh`).  ``Wave.rows`` carry global PE ids."""
    feed, stop = _plan_feed(emitter, device, mesh_size(mesh))
    try:
        while True:
            # un-phased: the consumer's stall on the planner (nonzero only
            # when planning, not execution, sets the pace)
            with obs.trace("plan/overlap/wait"):
                item = feed.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            lo, seg = item
            for wave in stream_waves(seg, batch=batch, prefetch=prefetch, device=device,
                                     mesh=mesh, check=check):
                yield _shifted(wave, lo)
    finally:
        stop.set()


def _local_waves(plan, mesh: LocalMesh, batch: int, prefetch: int, check: bool,
                 only=None) -> Iterator[Wave]:
    """:func:`stream_waves` on a :class:`LocalMesh` of several rows: the
    reference's ``wave_schedule(plan, D, batch)``, row ``d`` of each wave
    executed on row ``d``'s device and stream from its own slice of the
    plan's tables (uploaded once), one program call a row.  ``only``
    restricts the execution to those rows (the contract scan's cases)."""
    from .engine import slice_plan

    D, P = mesh.size, plan.num_pes
    with obs.trace("wave/schedule", phase="exec", D=D, batch=batch):
        ws = wave_schedule(plan, D, batch)
    if not ws.num_waves:
        return
    key = ("wave", plan.signature(), D, ws.batch)
    fn = _slot_fn("wave", key, plan.slot_fn)
    rows = tuple(range(D)) if only is None else tuple(only)
    state = {}
    for d in rows:
        with mesh.row(d) as dev:
            state[d] = (plan_tensors(slice_plan(plan, *mesh.pes(P, d)), dev),
                        torch.from_numpy(ws.sched[:, d, :, 0]).to(dev, torch.int64),
                        torch.from_numpy(ws.sched[:, d, :, 1]).to(dev, torch.int64),
                        torch.from_numpy(ws.valid[:, d]).to(dev))
    traced = obs.is_enabled()

    def step(w: int, d: int):
        tables, pes, slots, valid = state[d]
        payload, ok = fn(*(t[pes[w], slots[w]] for t in tables))
        return payload, ok & valid[w][:, None]

    def emit(w: int, outs, fences) -> Wave:
        for d in rows:
            if outs[d] is not None:
                mesh.hand_over(d, fences[d], outs[d])
        if traced:
            with obs.trace("wave/device", phase="exec"):
                mesh.sync()
        with obs.trace("wave/sink", phase="sink"):
            return Wave(tuple(None if o is None else o[0] for o in outs),
                        tuple(None if o is None else o[1] for o in outs),
                        tuple(r if d in rows else None for d, r in enumerate(ws.rows[w])))

    pending: deque = deque()
    for w in range(ws.num_waves):
        outs, fences = [None] * D, [None] * D
        for d in rows:
            if ws.rows[w][d] is None:
                continue
            with mesh.row(d), obs.trace("wave/dispatch", phase="exec", wave=w, row=d):
                outs[d] = _checked(_row_key(key, mesh, d), check, lambda: step(w, d))
                fences[d] = mesh.fence(d)
        pending.append((w, outs, fences))
        if len(pending) >= max(1, int(prefetch)):
            yield emit(*pending.popleft())
    while pending:
        yield emit(*pending.popleft())


def stream_waves(plan, batch: int = 1, prefetch: int = 2, device=None, *, mesh=None,
                 check: bool = False) -> Iterator[Wave]:
    """Stream a plan as :class:`Wave` slabs of ``D`` rows of ``batch``
    slots (one program call of ``D batch`` rows each); at most
    ``prefetch`` executed waves are held before they are yielded.  A
    :class:`PlanEmitter` streams through the plan/execute overlap path,
    with global PE ids in ``Wave.rows``.  ``check`` scans the wave
    program once (see the module docstring).

    ``mesh`` is ``None`` (:func:`placement`), the row count D dividing P,
    every row on the one card, a :class:`LocalMesh`, each row of each wave
    on its own device (:func:`_local_waves`; a planner thread plans on
    ``device``, by default the mesh's first), or a :class:`World`, whose
    rank streams its own PEs' slice on its own rows (:meth:`World.local`):
    rows ``[r k, (r+1) k)`` of the reference's ``size k``-row schedule,
    with global ``pe`` ids and rows.  A batch is clamped to the rank's
    longest per-PE run, which deals the same batches as the reference's
    clamp to the whole plan's."""
    if isinstance(mesh, World):
        part, lo = _rank_part(plan, mesh)
        row0, D = mesh.row_range()[0], mesh_size(mesh)
        for wave in stream_waves(part, batch=batch, prefetch=prefetch, device=mesh.bind(device),
                                 mesh=mesh.local(), check=check):
            yield _shifted(wave, lo, row0, D)
        return
    rows, dev = placement(plan.num_pes, mesh, device)
    if isinstance(plan, PlanEmitter):
        yield from _stream_emitter_waves(plan, rows, batch, prefetch, dev, check)
        return
    if isinstance(rows, LocalMesh):
        yield from _local_waves(plan, rows, batch, prefetch, check)
        return
    D = rows
    with obs.trace("wave/schedule", phase="exec", D=D, batch=batch):
        ws = wave_schedule(plan, D, batch)
    if not ws.num_waves:
        return
    key = ("wave", plan.signature(), D, ws.batch)
    fn = _slot_fn("wave", key, plan.slot_fn)
    tables = plan_tensors(plan, dev)
    B = ws.batch
    # [W, D B] global PE and slot of every row of a wave
    pes = ws.sched[..., 0] + (np.arange(D) * (plan.num_pes // D))[None, :, None]
    pes = torch.from_numpy(pes.reshape(-1, D * B)).to(dev, torch.int64)
    slots = torch.from_numpy(ws.sched[..., 1].reshape(-1, D * B)).to(dev, torch.int64)
    valid = torch.from_numpy(ws.valid.reshape(-1, D * B)).to(dev)
    traced = obs.is_enabled()

    def emit(rows, payload, ok) -> Wave:
        if traced:
            # measurement mode: wait for the card here so that device time
            # lands in its own span (queued waves overlap when disabled)
            with obs.trace("wave/device", phase="exec"):
                _sync(dev)
        with obs.trace("wave/sink", phase="sink"):
            return Wave(payload.reshape(D, B, *payload.shape[1:]),
                        ok.reshape(D, B, *ok.shape[1:]), rows)

    def step(w: int):
        payload, ok = fn(*(t[pes[w], slots[w]] for t in tables))
        return payload, ok & valid[w][:, None]

    pending: deque = deque()
    for w in range(ws.num_waves):
        with obs.trace("wave/dispatch", phase="exec", wave=w):
            payload, ok = _checked(key, check, lambda: step(w))
        pending.append((ws.rows[w], payload, ok))
        if len(pending) >= max(1, int(prefetch)):
            yield emit(*pending.popleft())
    while pending:
        yield emit(*pending.popleft())


# --------------------------------------------------------------------------
# slab execution: packed [D, B] rows from *different* plans (repro_torch.serve)
# --------------------------------------------------------------------------

def _upload(arrays: Sequence[np.ndarray], dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """The host tables as tensors on ``dev`` in one copy: packed into one
    byte buffer (pinned, on a card) at 16-byte aligned offsets, copied
    with ``non_blocking``, and viewed back (uint32 as int32, the same
    bits).  The pinned buffer is not reused before the copy ends: the
    caching host allocator records the copy's stream."""
    arrays = [np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a)
              for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += (a.nbytes + 15) // 16 * 16
    host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=dev.type == "cuda")
    flat = host.numpy()
    for a, o in zip(arrays, offs):
        flat[o: o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    return tuple(buf[o: o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).reshape(a.shape)
                 for a, o in zip(arrays, offs))


def _run_local_slab(fn: Callable, key: tuple, valid: np.ndarray, rows: Sequence[np.ndarray],
                    mesh: LocalMesh, check: bool, slot_kwargs: dict):
    """:func:`run_slab` on a :class:`LocalMesh`: row ``d`` of the slab is
    uploaded to row ``d``'s device (a pinned buffer of its own, which the
    caching host allocator keeps until that row's copy ends) and runs
    there under the row's stream; a row with no valid slot launches
    nothing.  Returns tuples of ``[B, ...]`` tensors a row (``None`` for
    a row that ran nothing), handed over to the caller's streams."""
    D, B = valid.shape
    out, fences = [None] * D, [None] * D
    for d in range(D):
        if not valid[d].any():
            continue
        with mesh.row(d) as dev:
            ok_row, *tables = _upload([valid[d]] + [r[d] for r in rows], dev)

            def step():
                payload, ok = fn(*tables, **slot_kwargs)
                return payload, ok & ok_row.reshape(B, 1)

            out[d] = _checked(_row_key(key, mesh, d), check, step)
            fences[d] = mesh.fence(d)
    for d, res in enumerate(out):
        if res is not None:
            mesh.hand_over(d, fences[d], res)
    return (tuple(None if o is None else o[0] for o in out),
            tuple(None if o is None else o[1] for o in out))


def run_slab(slot_fn_thunk: Callable[[], Callable], signature: tuple,
             valid: np.ndarray, rows: Sequence[np.ndarray], device=None, *,
             check: bool = True, mesh=None, **slot_kwargs):
    """Execute one packed ``[D, B]`` slab; returns ``(payload [D, B, ...],
    valid [D, B, L])`` on the device, padding rows masked.

    ``rows`` are the per-slot input tables (``[D, B, ...]`` numpy, one a
    table the slot function takes) assembled by the scheduler from any
    mix of plans sharing the program named by ``signature``; ``valid``
    masks the padding rows.  One card runs the whole slab as one batch of
    ``D B`` rows (one launch of each kernel of the program), after one
    upload of the tables.  ``slot_fn_thunk`` is called only on a miss of
    the slot-function cache; ``slot_kwargs`` go to the slot function
    (the pair program's ``stage``).  ``check`` scans the slab program
    once (see the module docstring).

    On a :class:`LocalMesh` of ``D`` rows (``mesh``) row ``d`` runs on
    row ``d``'s device, and ``payload`` and ``valid`` are tuples of its
    rows' ``[B, ...]`` tensors (:func:`_run_local_slab`)."""
    valid = np.asarray(valid, bool)
    D, B = valid.shape
    key = ("slab", signature, valid.shape,
           tuple((r.shape[2:], r.dtype.str) for r in rows))
    fn = _slot_fn("slab", key, slot_fn_thunk)
    if isinstance(mesh, LocalMesh):
        if mesh.size != D:
            raise ValueError(f"a slab of {D} rows on a mesh of {mesh.size}")
        with obs.trace("slab/exec", phase="exec", mode="slab"):
            out = _run_local_slab(fn, key, valid, rows, mesh, check, slot_kwargs)
            if obs.is_enabled():
                mesh.sync()
        return out
    dev = resolve_device(device)
    ok_rows, *tables = _upload([valid] + list(rows), dev)
    def step():
        payload, ok = fn(*(t.reshape(D * B, *t.shape[2:]) for t in tables), **slot_kwargs)
        return payload, ok & ok_rows.reshape(D * B, 1)

    with obs.trace("slab/exec", phase="exec", mode="slab"):
        payload, ok = _checked(key, check, step)
        if obs.is_enabled():
            _sync(dev)
    return (payload.reshape(D, B, *payload.shape[1:]),
            ok.reshape(D, B, *ok.shape[1:]))


def stream_slots(plan, batch: int = 1, prefetch: int = 2, device=None, *, mesh=None,
                 check: bool = False
                 ) -> Iterator[Tuple[int, np.ndarray, torch.Tensor, torch.Tensor]]:
    """Flattened :func:`stream_waves`: ``(pe, slots, payload, valid)``
    per batch (pe-major for ``D = 1`` and on a one-card :class:`World`
    rank; on a :class:`LocalMesh` each row's on its device, rows in order
    within a wave); takes a :class:`PlanEmitter` too (``pe`` is then the
    global PE id)."""
    for wave in stream_waves(plan, batch=batch, prefetch=prefetch, device=device, mesh=mesh,
                             check=check):
        yield from wave.chunks()
