"""Executor for the port's plans on one device (port of the run and
wave-streaming half of ``repro.distrib.runtime``).

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
  consumer takes them.  The sampler reads its duplicate flag on the
  host once per round, so a wave does not overlap the next one.

There are no collectives: one card executes every virtual PE's rows.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def plan_tensors(plan, device) -> Tuple[torch.Tensor, ...]:
    """The plan's tables as tensors on ``device`` (uint32 tables as int32
    tensors holding the same bits)."""
    out = []
    for a in plan.input_arrays():
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


def run(plan, device=None):
    """Execute a plan's full table; returns ``(payload, valid)``."""
    dev = resolve_device(device)
    tables = plan_tensors(plan, dev)
    P, C = tables[0].shape[:2]      # every plan kind's tables are [P, C, ...]
    rows = [t.reshape(P * C, *t.shape[2:]) for t in tables]
    payload, valid = plan.slot_fn()(*rows)
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
    row (the reference's schedule; the port runs it with ``D = 1``)."""
    index = np.asarray(plan.stream_index())
    P = plan.num_pes
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
    masked; ``rows[d]`` names its PE and slot ids."""
    payload: torch.Tensor   # [D, B, ...]
    valid: torch.Tensor     # [D, B, L]
    rows: tuple             # [D] -> (pe, slots) | None

    def chunks(self) -> Iterator[Tuple[int, np.ndarray, torch.Tensor, torch.Tensor]]:
        """Yield ``(pe, slots, payload [B, ...], valid [B, L])`` per
        non-empty mesh row (ragged tails are masked, not trimmed)."""
        for d, row in enumerate(self.rows):
            if row is None:
                continue
            pe, slots = row
            yield pe, slots, self.payload[d], self.valid[d]


def stream_waves(plan, batch: int = 1, prefetch: int = 2,
                 device=None) -> Iterator[Wave]:
    """Stream a plan as :class:`Wave` slabs of ``batch`` rows; at most
    ``prefetch`` executed waves are held before they are yielded."""
    dev = resolve_device(device)
    ws = wave_schedule(plan, 1, batch)
    if not ws.num_waves:
        return
    fn = plan.slot_fn()
    tables = plan_tensors(plan, dev)
    sched = torch.from_numpy(ws.sched[:, 0]).to(dev, torch.int64)  # [W, B, 2]
    valid = torch.from_numpy(ws.valid[:, 0]).to(dev)                # [W, B]
    pending: deque = deque()
    for w in range(ws.num_waves):
        s = sched[w]
        payload, ok = fn(*(t[s[:, 0], s[:, 1]] for t in tables))
        pending.append(Wave(payload[None], (ok & valid[w][:, None])[None],
                            ws.rows[w]))
        if len(pending) >= max(1, int(prefetch)):
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def stream_slots(plan, batch: int = 1, prefetch: int = 2, device=None
                 ) -> Iterator[Tuple[int, np.ndarray, torch.Tensor, torch.Tensor]]:
    """Flattened :func:`stream_waves`: ``(pe, slots, payload, valid)``
    per batch, pe-major."""
    for wave in stream_waves(plan, batch=batch, prefetch=prefetch, device=device):
        yield from wave.chunks()
