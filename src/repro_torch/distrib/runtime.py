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

``mesh`` is the reference's mesh.  A row count ``D`` deals a plan's PEs
onto ``D`` rows of each wave, all on the one card; it must divide P.  A
:class:`~repro_torch.distrib.world.World` makes the caller one rank of
a world, a process on a card of its own: :func:`run` and
:func:`stream_waves` plan rows ``[d P/D, (d+1) P/D)`` only, upload and
execute them alone, and yield the reference's mesh row ``d``.

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
from .world import World, check_rows


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


def run(plan, device=None, check: bool = True, mesh=None):
    """Execute a plan's full table; returns ``(payload, valid)``.

    ``mesh`` is ``None``, a row count D dividing P (every row on the one
    card; the output does not depend on it) or a :class:`World`: its rank
    uploads and executes only its own rows, and gets its shard ``[P/D, C,
    ...]`` of the payload, on the world's device."""
    if isinstance(mesh, World):
        lo, hi = mesh.pes(plan.num_pes)
        device = mesh.bind(device)
        from .engine import slice_plan
        plan = slice_plan(plan, lo, hi)
    elif mesh is not None:
        check_rows(plan.num_pes, int(mesh))
    dev = resolve_device(device)
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

    A rank of a :class:`World` holds its own row only: ``payload`` and
    ``valid`` are ``[1, B, ...]``, ``row0`` is the rank, and ``rows`` is
    ``None`` at every other rank's row."""
    payload: torch.Tensor   # [D, B, ...] ([1, B, ...] on a world)
    valid: torch.Tensor     # [D, B, L]
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


def _stream_emitter_waves(emitter: PlanEmitter, D: int, batch: int, prefetch: int,
                          device: torch.device, check: bool) -> Iterator[Wave]:
    """:func:`stream_waves` over a lazily segmented plan: execute segment
    k's waves while the planner thread emits segment k+1.  ``Wave.rows``
    carry global PE ids."""
    feed, stop = _plan_feed(emitter, device, D)
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
                                     mesh=D, check=check):
                if lo:
                    wave = Wave(wave.payload, wave.valid,
                                tuple(None if r is None else (r[0] + lo, r[1])
                                      for r in wave.rows))
                yield wave
    finally:
        stop.set()


def _rank_waves(plan, world: World, batch: int, prefetch: int, device,
                check: bool) -> Iterator[Wave]:
    """:func:`stream_waves` on a rank of ``world``: row ``d = rank`` of the
    reference's ``wave_schedule(plan, size, batch)``, the same ``(pe,
    slots)`` batches in the same order, executed alone (the rank's rows
    are all it plans, uploads and holds; it waits on no other rank).  A
    batch is clamped to the rank's longest per-PE run, which deals the
    same batches as the reference's clamp to the whole plan's."""
    lo, hi = world.pes(plan.num_pes)
    dev = world.bind(device)
    if isinstance(plan, PlanEmitter):
        part = PlanEmitter(hi - lo, lambda a, b: plan.build(lo + a, lo + b), plan.segments)
    else:
        from .engine import slice_plan
        part = slice_plan(plan, lo, hi)
    d, D = world.rank, world.size
    for wave in stream_waves(part, batch=batch, prefetch=prefetch, device=dev, check=check):
        rows = [None] * D
        rows[d] = None if wave.rows[0] is None else (wave.rows[0][0] + lo, wave.rows[0][1])
        yield Wave(wave.payload, wave.valid, tuple(rows), d)


def stream_waves(plan, batch: int = 1, prefetch: int = 2, device=None, *, mesh=1,
                 check: bool = False) -> Iterator[Wave]:
    """Stream a plan as :class:`Wave` slabs of ``D`` rows of ``batch``
    slots (one program call of ``D batch`` rows each); at most
    ``prefetch`` executed waves are held before they are yielded.  A
    :class:`PlanEmitter` streams through the plan/execute overlap path,
    with global PE ids in ``Wave.rows``.  ``check`` scans the wave
    program once (see the module docstring).

    ``mesh`` is the row count D dividing P, every row on the one card, or
    a :class:`World`, whose rank streams its own row ``d`` of the
    reference's schedule (:func:`_rank_waves`)."""
    if isinstance(mesh, World):
        yield from _rank_waves(plan, mesh, batch, prefetch, device, check)
        return
    D = int(mesh)
    dev = resolve_device(device)
    if isinstance(plan, PlanEmitter):
        yield from _stream_emitter_waves(plan, D, batch, prefetch, dev, check)
        return
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


def run_slab(slot_fn_thunk: Callable[[], Callable], signature: tuple,
             valid: np.ndarray, rows: Sequence[np.ndarray], device=None, *,
             check: bool = True, **slot_kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
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
    once (see the module docstring)."""
    dev = resolve_device(device)
    valid = np.asarray(valid, bool)
    D, B = valid.shape
    key = ("slab", signature, valid.shape,
           tuple((r.shape[2:], r.dtype.str) for r in rows))
    fn = _slot_fn("slab", key, slot_fn_thunk)
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


def stream_slots(plan, batch: int = 1, prefetch: int = 2, device=None, *, mesh=1,
                 check: bool = False
                 ) -> Iterator[Tuple[int, np.ndarray, torch.Tensor, torch.Tensor]]:
    """Flattened :func:`stream_waves`: ``(pe, slots, payload, valid)``
    per batch (pe-major for ``D = 1`` and on a :class:`World`'s rank);
    takes a :class:`PlanEmitter` too (``pe`` is then the global PE id)."""
    for wave in stream_waves(plan, batch=batch, prefetch=prefetch, device=device, mesh=mesh,
                             check=check):
        yield from wave.chunks()
