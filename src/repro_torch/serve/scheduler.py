"""Mixed-request slab scheduler: many plans, one batched program (port of
``repro.serve.scheduler``).

The runtime's wave streamer executes one plan's next slots per launch.
Serving wants the transpose: at any moment many requests are in flight
(different families, seeds and sizes), and launching them one plan at a
time would leave the card mostly idle.  The scheduler packs *ready slots
from different requests* into shared ``[D, B]`` slabs (D rows of B
slots: the reference's mesh rows, a row count on one card or the rows of
a :class:`~repro_torch.distrib.world.LocalMesh`) and executes each
through :func:`repro_torch.distrib.runtime.run_slab`: one launch of each
kernel of the program over its ``D B`` rows on one card, or one a mesh
row on the row's device.

This is sound because a slot is a pure function of its row (the paper's
communication-free invariant one level down), and exact because:

* **Capacity independence**: every per-slot draw is counter-indexed, so
  a chunk row run at any capacity at least its count yields the same
  valid prefix, and a pair row's valid (i, j) hits are the same set in
  the same order at any capacity at least its cell counts.  Slabs run at
  a power-of-two *capacity class*.  GEOM_CERT rows, whose emit bitmask
  is indexed by ``pair_slot_index(i, j, capacity)``, keep their exact
  capacity.
* **Kind dispatch is per row**: a chunk slab may mix G(n,m), SBM and BA
  rows (RMAT rows keyed by their depth), a pair slab RGG and RHG rows,
  and each row takes its own plan's path.

Placement, the round robin over groups, the sequence numbers, the fault
model (lost slots retired and reissued onto the survivors of
:func:`repro_torch.distrib.fault.reassign_after_failure`) and the
registry metrics are the reference's.  The host side works on arrays:
an admitted plan's rows are queued as one block of ``[S, ...]`` tables,
a slab takes ranges of blocks, placement is arithmetic on the slots'
indices, and each sink receives one run of consecutive slots a slab
(plus one per gap a fault leaves), so a slab costs array work, not
Python work a slot.  ``slab_bytes`` (off by default, as in the
reference) widens the rows of a group whose slots are small: its slabs
then take as many slots as fit in that many bytes of output.
"""
from __future__ import annotations

import queue as _queue
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..distrib import engine, fault, runtime
from ..distrib.world import LocalMesh

__all__ = ["SlabProgram", "Scheduler", "program_of"]


def _capacity_class(cap: int, floor: int) -> int:
    """Smallest power of two >= cap (>= floor): the shared slab capacity."""
    c = floor
    while c < cap:
        c <<= 1
    return c


@dataclass(frozen=True)
class SlabProgram:
    """The batched program one packing group shares.

    Every plan whose rows this program runs exactly maps to the same
    ``SlabProgram`` (see :func:`program_of`), and every slab of the group
    reuses one slot function, cached by :meth:`signature`.
    """
    plan_kind: str            # "chunk" | "pair"
    capacity: int             # shared slab capacity (class bound, or exact)
    W: int                    # PRNG key words
    rng_impl: str
    kinds: Tuple[int, ...]    # KIND_* / GEOM_* paths the program runs
    dim: int = 2              # pair: spatial dimension
    log_n: int = 0            # chunk: RMAT descent depth (0 = no RMAT path)
    K: int = 1                # pair: gid words
    G: int = 1                # pair: geometry features
    F: int = 1                # pair: float params

    def signature(self) -> tuple:
        return ("serve", self.plan_kind, self.capacity, self.W, self.rng_impl,
                self.kinds, self.dim, self.log_n, self.K, self.G, self.F)

    @property
    def slot_bytes(self) -> int:
        """Output bytes of one slot: a 16-byte edge and a keep byte for
        each of its ``capacity`` (chunk) or ``capacity^2`` (pair) slots."""
        return 17 * (self.capacity if self.plan_kind == "chunk" else self.capacity ** 2)

    def slot_fn(self):
        if self.plan_kind == "chunk":
            return engine._edge_chunk_fn(self.capacity, self.rng_impl, self.kinds,
                                         self.log_n)
        return engine._pair_fn(self.capacity, self.rng_impl, self.kinds, self.dim)

    def slot_kwargs(self, rows: List[np.ndarray]) -> dict:
        """What the slot function takes besides a slab's tables: for a pair
        slab, each kind's largest count among its active rows, which
        bounds the points ``pair_edges`` stages for that kind (the rows
        run at the class capacity, above their own)."""
        if self.plan_kind == "chunk":
            return {}
        kind, most, active = rows[0], np.maximum(rows[3], rows[4]), rows[11]
        return {"stage": {k: min(self.capacity, int(most[(kind == k) & active].max(initial=0)))
                          for k in (engine.GEOM_HYP, engine.GEOM_TORUS) if k in self.kinds}}

    def slab_arrays(self, D: int, B: int) -> List[np.ndarray]:
        """Fresh row tables of one ``[D, B]`` slab, padded as the plan
        emitters pad their tables (geometry 1s)."""
        if self.plan_kind == "chunk":
            return [np.zeros((D, B), np.int32),            # kind (EMPTY)
                    np.zeros((D, B, self.W), np.uint32),   # key_data
                    np.zeros((D, B), np.int64),            # universe
                    np.zeros((D, B), np.int64),            # count
                    np.zeros((D, B, 3), np.int64),         # params
                    np.zeros((D, B, 4), np.float64),       # fparams
                    np.zeros((D, B), bool)]                # owned
        return [np.zeros((D, B), np.int32),                # kind (EMPTY)
                np.zeros((D, B, self.W), np.uint32),       # key_a
                np.zeros((D, B, self.W), np.uint32),       # key_b
                np.zeros((D, B), np.int64),                # count_a
                np.zeros((D, B), np.int64),                # count_b
                np.zeros((D, B, self.K), np.int64),        # gid_a
                np.zeros((D, B, self.K), np.int64),        # gid_b
                np.ones((D, B, self.G), np.float64),       # geom_a
                np.ones((D, B, self.G), np.float64),       # geom_b
                np.zeros((D, B, self.F), np.float64),      # fparams
                np.zeros((D, B), bool),                    # self_pair
                np.zeros((D, B), bool)]                    # active

    def gather_rows(self, plan) -> List[np.ndarray]:
        """Plan rows in stream order, padded to this program's widths:
        ``[S, ...]`` per input table (S = number of streamed slots)."""
        index = np.asarray(plan.stream_index(), np.int64).reshape(-1, 2)
        i, j = index[:, 0], index[:, 1]
        vals = [np.asarray(a[i, j]) for a in plan.input_arrays()]
        if self.plan_kind == "pair":
            for p, fill in ((5, 0), (6, 0), (7, 1.0), (8, 1.0), (9, 0.0)):
                width = (self.K, self.K, self.G, self.G, self.F)[p - 5]
                v = vals[p]
                if v.shape[-1] > width:
                    raise ValueError(
                        f"plan width {v.shape[-1]} exceeds program width "
                        f"{width} for input {p}")
                if v.shape[-1] < width:
                    out = np.full(v.shape[:-1] + (width,), fill, v.dtype)
                    out[..., : v.shape[-1]] = v
                    vals[p] = out
        return vals


def program_of(plan) -> SlabProgram:
    """The packing group a plan's slots run under.

    Chunk plans of one capacity class share a program running every
    sampled kind and BA (RMAT plans also key on their descent depth), so
    G(n,m), G(n,p), SBM and BA rows pack together.  Pair plans without
    CERT rows share the HYP + TORUS program per (capacity class, dim), so
    RGG and RHG rows pack together; CERT plans key on their exact
    capacity (the emit bitmask is capacity-indexed).
    """
    if isinstance(plan, engine.ChunkPlan):
        log_n = plan.rmat_log_n
        kinds = sorted(set(engine.SAMPLED_KINDS) | {engine.KIND_BA}
                       | ({engine.KIND_RMAT} if log_n else set()))
        return SlabProgram("chunk", _capacity_class(plan.capacity, 64),
                           plan.key_data.shape[-1], plan.rng_impl,
                           tuple(kinds), log_n=log_n)
    if isinstance(plan, engine.PairPlan):
        W = plan.key_a.shape[-1]
        if engine.GEOM_CERT in plan.kinds_present:
            return SlabProgram("pair", plan.capacity, W, plan.rng_impl,
                               plan.kinds_present, dim=plan.dim,
                               K=plan.gid_a.shape[-1],
                               G=plan.geom_a.shape[-1],
                               F=plan.fparams.shape[-1])
        return SlabProgram("pair", _capacity_class(plan.capacity, 8), W,
                           plan.rng_impl,
                           (engine.GEOM_HYP, engine.GEOM_TORUS),
                           dim=plan.dim, K=1, G=max(4, plan.dim), F=2)
    raise TypeError(f"no slab program for plan type {type(plan).__name__}")


class _Block:
    """One admitted plan (or plan segment) in a group's queue: its slots'
    rows as ``[S, ...]`` tables in stream order, their PEs, the first
    sequence number and how many slots have left the queue."""
    __slots__ = ("sink", "seq0", "pe", "vals", "pos")

    def __init__(self, sink, seq0: int, pe: np.ndarray, vals: List[np.ndarray]):
        self.sink, self.seq0, self.pe, self.vals, self.pos = sink, seq0, pe, vals, 0

    def __len__(self) -> int:
        return len(self.pe) - self.pos


class _Slots:
    """The slots of one slab in queue order (slot k = the k-th taken):
    their sinks (``sinks[owner[k]]``), sequence numbers, PEs and row
    values."""
    __slots__ = ("sinks", "owner", "seq", "pe", "vals")

    def __init__(self, parts: List[Tuple[_Block, int, int]]):
        def cat(arrays):
            return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)

        self.sinks: list = []
        owner, index = [], {}
        for b, lo, hi in parts:
            u = index.setdefault(id(b.sink), len(self.sinks))
            if u == len(self.sinks):
                self.sinks.append(b.sink)
            owner.append(np.full(hi - lo, u, np.int64))
        self.owner = cat(owner)
        self.seq = cat([b.seq0 + np.arange(lo, hi) for b, lo, hi in parts])
        self.pe = cat([b.pe[lo:hi] for b, lo, hi in parts])
        self.vals = [cat([b.vals[t][lo:hi] for b, lo, hi in parts])
                     for t in range(len(parts[0][0].vals))]


class _Group:
    """One packing group: a program, its slabs' slots a row, and its FIFO
    of admitted blocks."""
    __slots__ = ("program", "B", "queue")

    def __init__(self, program: SlabProgram, B: int):
        self.program = program
        self.B = B
        self.queue: deque = deque()   # _Block

    @property
    def pending(self) -> int:
        return sum(len(b) for b in self.queue)

    def take(self, n: int, consume: bool) -> _Slots:
        """The next ``n`` slots in FIFO order (leaving the queue when
        ``consume``)."""
        parts, left = [], n
        for b in self.queue:
            k = min(left, len(b))
            parts.append((b, b.pos, b.pos + k))
            left -= k
            if not left:
                break
        if consume:
            for b, lo, hi in parts:
                b.pos = hi
            while self.queue and not len(self.queue[0]):
                self.queue.popleft()
        return _Slots(parts)


class _Admission:
    """One in-flight lazily segmented request: the background planner's
    segment feed plus the request's running sequence base."""
    __slots__ = ("feed", "sink", "base")

    def __init__(self, feed: _queue.Queue, sink):
        self.feed = feed
        self.sink = sink
        self.base = 0


class Scheduler:
    """Packs pending slots of all in-flight requests into slabs.

    ``enqueue`` appends a plan's slots (in its stream order) to the FIFO
    of their packing group; each ``tick`` takes up to ``D * B`` slots of
    one group into a slab and hands the results to the requests' sinks.
    Requests admitted between ticks join partially drained queues, so
    their slots ride the very next slab beside older requests'
    remainders (continuous batching).

    ``D`` is the slab's row count (the reference's mesh rows; 1 is
    ``mesh_for(P)`` on one device), every row on ``device`` in one launch.
    ``mesh``, a :class:`~repro_torch.distrib.world.LocalMesh`, takes its
    place: row ``d`` of every slab runs on row ``d``'s device (a fault's
    lost slots then recompute on the surviving rows' devices).
    ``slab_batch`` is the slots a row.
    With ``slab_bytes``, a group whose slots are small takes more of them
    a row: as many as fit in ``slab_bytes`` of output a slab, and never
    fewer than ``slab_batch`` (pair rows of capacity 32 are 17 KB, chunk
    rows of capacity 2^22 71 MB).  Results stay on their rows' devices;
    planning runs on ``device`` (a mesh's first by default).
    ``check`` scans each new slab program once (``runtime.run_slab``).
    """

    def __init__(self, D: int = 1, slab_batch: int = 8, slab_bytes: Optional[int] = None,
                 registry: Optional[obs.Registry] = None, device=None, check: bool = True,
                 mesh: Optional[LocalMesh] = None):
        if mesh is not None:
            if D != 1:
                raise ValueError("give a Scheduler a mesh or a row count D, not both")
            D = mesh.size
            device = mesh.devices[0] if device is None else device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.D = int(D)
        self.check = bool(check)
        self.B = int(slab_batch)
        if self.D < 1 or self.B < 1:
            raise ValueError(f"slabs need D >= 1 and slab_batch >= 1, got {D}, {slab_batch}")
        self.slab_bytes = None if slab_bytes is None else int(slab_bytes)
        self.device = runtime.resolve_device(device)
        self._groups: Dict[tuple, _Group] = {}
        self._admissions: List[_Admission] = []
        self._rr = 0
        self._fault: Optional[Tuple[int, Tuple[int, ...]]] = None
        self.slabs = 0
        self.slots = 0
        self.reissued = 0
        self.registry = registry if registry is not None \
            else obs.Registry("repro_serve_")
        r = self.registry
        self._m_slabs = r.counter("slabs_total", "slabs executed")
        self._m_slots = r.counter("slots_total", "slots executed")
        self._m_reissued = r.counter(
            "reissued_total", "slots recomputed after mesh-row faults")
        self._m_fill = r.histogram(
            "slab_fill_fraction", "occupied fraction of each [D, B] slab",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        r.gauge("queue_depth", "pending slots across packing groups",
                fn=lambda: float(self.pending))
        r.gauge("packing_groups", "live packing groups",
                fn=lambda: float(len(self._groups)))

    def enqueue(self, plan, sink) -> Optional[int]:
        """Admit one request's plan; returns its slot count.

        Takes a :class:`repro_torch.distrib.runtime.PlanEmitter` too: its
        segments are then built on a background planner thread and
        admitted as they arrive, so a request's first results land before
        its plan is whole.  The sink's sequence numbers (segment base +
        stream order within the segment) are the full plan's stream
        order, so delivery is unchanged; returns ``None`` (the total is
        known only when the last segment lands)."""
        if isinstance(plan, runtime.PlanEmitter):
            feed, _ = runtime._plan_feed(plan, self.device)
            self._admissions.append(_Admission(feed, sink))
            self._admit_ready()
            return None
        S = self._admit(plan, sink, 0)
        sink.expect(S)
        return S

    def _admit(self, plan, sink, base: int, pe0: int = 0) -> int:
        """Queue one plan's slots (stream order, seqs from ``base``, PEs
        offset by ``pe0``) in their packing group; returns the count."""
        prog = program_of(plan)
        key = prog.signature()
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(prog, self._width(prog))
        vals = group.program.gather_rows(plan)
        pe = np.asarray(plan.stream_index(), np.int64).reshape(-1, 2)[:, 0] + pe0
        if len(pe):
            group.queue.append(_Block(sink, base, pe, vals))
        return len(pe)

    def _admit_ready(self, block: bool = False) -> None:
        """Move finished plan segments from background planners into
        packing groups.  All scheduler state changes here, on the consumer
        thread: planner threads only build tables.  With ``block=True``
        (nothing else runnable) wait for one segment when no planner has
        produced anything yet."""
        progressed = False
        for adm in list(self._admissions):
            while adm in self._admissions:
                try:
                    item = adm.feed.get_nowait()
                except _queue.Empty:
                    break
                progressed = True
                self._apply_segment(adm, item)
        if block and not progressed and self._admissions:
            adm = self._admissions[0]
            self._apply_segment(adm, adm.feed.get())

    def _apply_segment(self, adm: _Admission, item) -> None:
        if item is None:          # planner exhausted: the total is known
            self._admissions.remove(adm)
            adm.sink.expect(adm.base)
            return
        if isinstance(item, BaseException):
            self._admissions.remove(adm)
            raise item
        lo, seg = item
        adm.base += self._admit(seg, adm.sink, adm.base, pe0=lo)

    def _width(self, prog: SlabProgram) -> int:
        """Slots a slab row of ``prog``'s group."""
        if self.slab_bytes is None:
            return self.B
        return max(self.B, self.slab_bytes // (self.D * prog.slot_bytes))

    @property
    def pending(self) -> int:
        return sum(g.pending for g in self._groups.values())

    @property
    def emitting(self) -> bool:
        """True while an admitted request's background planner is still
        emitting segments (more slots will arrive)."""
        return bool(self._admissions)

    def wait_segment(self) -> None:
        """Block until at least one pending segment is admitted (no-op
        when nothing is emitting): the idle-but-emitting path of
        :meth:`drain` and the service loop."""
        self._admit_ready(block=True)

    def inject_fault(self, dead_rows, at_slab: Optional[int] = None) -> None:
        """Arm a one-shot failure: the given slab rows die during slab
        ``at_slab`` (default: the next one).  Their results are discarded
        and the lost slots reissued onto the survivors."""
        when = self.slabs if at_slab is None else int(at_slab)
        self._fault = (when, tuple(int(d) for d in dead_rows))

    def _next_slab(self, consume: bool):
        """``(group, slots, placement, assignment)`` of the next slab: up
        to ``D * B`` slots of the next non-empty group (round robin over
        groups, so no family starves), or None when idle."""
        groups = [g for g in self._groups.values() if g.queue]
        if not groups:
            return None
        group = groups[self._rr % len(groups)]
        take = min(group.pending, self.D * group.B)
        assignment = fault.ChunkAssignment(take, tuple(range(self.D)))
        return (group, group.take(take, consume),
                self._place(np.arange(take), assignment, group.B), assignment)

    def tick(self) -> bool:
        """Execute one slab.  False when idle."""
        self._admit_ready()
        slab = self._next_slab(consume=True)
        if slab is None:
            return False
        self._rr += 1
        self._execute(*slab)
        return True

    @staticmethod
    def _place(ids: np.ndarray, assignment: fault.ChunkAssignment, B: int):
        """Deterministic slot -> (slab row, column) placement, the
        reference's: slot ``k`` goes to ``assignment.worker_of(k)`` (the
        slab's map, or the survivors' remap), each row's columns in slot
        order, at most ``B`` a row.  Returns the placed slots' ``(k, row,
        column)`` as arrays."""
        ids = np.asarray(ids, np.int64)
        rows = assignment.workers_of(ids)
        cols = np.empty(len(ids), np.int64)
        for d in np.unique(rows):
            on = rows == d
            cols[on] = np.arange(int(on.sum()))
        fit = cols < B
        return ids[fit], rows[fit], cols[fit]

    def _assemble(self, prog: SlabProgram, slots: _Slots, placement, B: int):
        """One ``[D, B]`` slab's valid mask and row tables."""
        ks, d, b = placement
        valid = np.zeros((self.D, B), bool)
        valid[d, b] = True
        rows = prog.slab_arrays(self.D, B)
        for arr, val in zip(rows, slots.vals):
            arr[d, b] = val[ks]
        return valid, rows

    def peek_slab(self):
        """Assemble, but neither dequeue nor execute, the next slab:
        ``(program, valid, rows)``, exactly what :meth:`tick` would run."""
        slab = self._next_slab(consume=False)
        if slab is None:
            raise RuntimeError("no pending slots to assemble")
        group, slots, placement, _ = slab
        valid, rows = self._assemble(group.program, slots, placement, group.B)
        return group.program, valid, rows

    def _execute(self, group: _Group, slots: _Slots, placement, assignment) -> None:
        prog, B = group.program, group.B
        ks, d, b = placement
        valid, rows = self._assemble(prog, slots, placement, B)
        payload, ok = runtime.run_slab(prog.slot_fn, prog.signature(), valid, rows,
                                       self.device, check=self.check, mesh=self.mesh,
                                       **prog.slot_kwargs(rows))
        if self.mesh is None:   # one [D B] row: a run may span two slab rows
            payload = (payload.reshape(self.D * B, *payload.shape[2:]),)
            ok = (ok.reshape(self.D * B, *ok.shape[2:]),)
            width = self.D * B
        else:
            width = B
        self.slabs += 1
        self.slots += len(ks)
        self._m_slabs.inc()
        self._m_slots.inc(len(ks))
        self._m_fill.observe(len(ks) / float(self.D * B))
        self.registry.counter(
            "group_slabs_total", "slabs per packing group",
            labels={"group": prog.plan_kind}).inc()

        dead: set = set()
        if self._fault is not None and self.slabs > self._fault[0]:
            dead = set(self._fault[1])
            self._fault = None

        alive = ~np.isin(d, sorted(dead))
        lost = ks[~alive]
        with obs.trace("serve/deliver", phase="sink", slab=self.slabs):
            self._deliver(slots, ks[alive], d[alive] * B + b[alive], width, payload, ok,
                          self.device)

        if len(lost):
            # retire and reissue: the deterministic survivor map decides
            # where every lost slot recomputes (no state moves)
            remap = fault.reassign_after_failure(assignment, sorted(dead))
            self.reissued += len(lost)
            self._m_reissued.inc(len(lost))
            obs.event("fault_reissue", lost=len(lost), dead=sorted(dead))
            remaining = lost
            while len(remaining):
                placed = self._place(remaining, remap, B)
                self._execute(group, slots, placed, remap)
                remaining = remaining[~np.isin(remaining, placed[0])]

    @staticmethod
    def _deliver(slots: _Slots, ks: np.ndarray, flat: np.ndarray, width: int,
                 payload, ok, device=None) -> None:
        """Hand each sink its delivered slots ``ks`` (at flat slab rows
        ``flat``) as runs of consecutive sequence numbers: one slice of
        the slab a run where its rows are contiguous there, else one
        gather.  ``payload`` and ``ok`` hold the slab's rows as tensors of
        ``width`` slots each (one of ``D B`` on one card; a mesh row's
        ``B`` on its device).  A run whose slots lie in several mesh rows
        (the placement deals consecutive slots round robin) is gathered
        row by row onto ``device``, in sequence order."""
        owner = slots.owner[ks]
        for u in np.unique(owner):
            on = np.flatnonzero(owner == u)
            order = on[np.argsort(slots.seq[ks[on]], kind="stable")]
            k, f = ks[order], flat[order]
            seq, part = slots.seq[k], f // width
            bounds = np.concatenate(([0], np.flatnonzero(np.diff(seq) != 1) + 1, [len(k)]))
            for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
                parts, idx = part[lo:hi], f[lo:hi] - part[lo:hi] * width
                if (parts == parts[0]).all():
                    rows, mask = payload[parts[0]], ok[parts[0]]
                    if (np.diff(idx) == 1).all():
                        p, m = rows[idx[0]: idx[-1] + 1], mask[idx[0]: idx[-1] + 1]
                    else:
                        sel = torch.from_numpy(idx).to(rows.device)
                        p, m = rows[sel], mask[sel]
                else:
                    p, m = Scheduler._gather(payload, ok, parts, idx, device)
                slots.sinks[u].deliver(int(seq[lo]), p, m, slots.pe[k[lo:hi]])

    @staticmethod
    def _gather(payload, ok, parts: np.ndarray, idx: np.ndarray, device):
        """Slots ``idx`` of mesh rows ``parts`` (one pair a slot) as one
        ``[k, ...]`` payload and mask on ``device``, in the given order:
        one gather a row, copied onto ``device``."""
        d0 = int(parts[0])
        p = torch.empty((len(idx), *payload[d0].shape[1:]), dtype=payload[d0].dtype,
                        device=device)
        m = torch.empty((len(idx), *ok[d0].shape[1:]), dtype=ok[d0].dtype, device=device)
        for d in np.unique(parts).tolist():
            on = parts == d
            sel = torch.from_numpy(idx[on]).to(payload[d].device)
            dst = torch.from_numpy(np.flatnonzero(on)).to(device)
            p[dst] = payload[d][sel].to(device)
            m[dst] = ok[d][sel].to(device)
        return p, m

    def drain(self) -> None:
        while True:
            if self.tick():
                continue
            if not self.emitting:
                return
            # idle while a background planner still emits: wait for its
            # next segment instead of spinning
            self.wait_segment()
