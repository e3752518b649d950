"""A world of ranks that generate their own PEs with no collective (the
port of the reference's multi-device and multi-process ``mesh=``).

The reference spreads P virtual PEs over a mesh of D devices, possibly
in several processes (``jax.make_mesh``): mesh row ``d`` holds PEs
``[d P/D, (d+1) P/D)``, each process builds and executes only the rows
it can address (every device it sees, in process-major order), and
``Wave.rows`` is ``None`` for the others.  The port runs one rank a
process: a :class:`World` names the rank, the world's size and the
rank's k local cards, and every entry point that takes ``mesh=world``
plans, uploads and executes only the rank's PEs, over its k rows.  The
world has ``size k`` mesh rows; rank r holds rows ``[r k, (r+1) k)``.

Generation needs no process group: every PE's output is a pure function
of ``(spec, P, pe)``, so a rank never waits on another and nothing is
exchanged.  Gathering the ranks' results is the caller's own business
(concatenating the ranks' edges in rank order gives the one-process
edges, bit for bit).

    >>> w = World(rank=1, size=2, devices="cpu")
    >>> w.pes(8)
    (4, 8)
    >>> World(1, 2, ["cpu", "cpu"]).row_range()
    (2, 4)

A :class:`LocalMesh` is the reference's default single-process mesh
(``runtime.mesh_for(P)``, a 1-D mesh over the local devices): one
process, one device a mesh row.  Row ``d`` holds PEs ``[d P/D, (d+1)
P/D)`` as on a world, and every row's work is uploaded to, launched on
and left on its own device.  Rows on distinct cards run on each card's
current stream; rows that share a device (the CPU tests, or several rows
on one card) each get a CUDA stream of their own, so the same per-row
code runs whether the rows share one card or have eight.  A rank of a
world runs its k rows as a :class:`LocalMesh` (:meth:`World.local`).

    >>> m = LocalMesh(["cpu", "cpu"])
    >>> m.pes(8, 1)
    (4, 8)
"""
from __future__ import annotations

import functools
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import torch

from ..kernels.build import resolve_device


def check_rows(P: int, D: int) -> None:
    """Raise unless ``D`` mesh rows can shard ``P`` PEs."""
    if D < 1 or P % D:
        raise ValueError(f"mesh of {D} devices cannot shard a {P}-PE plan: "
                         f"P % devices must be 0")


@dataclass(frozen=True)
class World:
    """Rank ``rank`` of a world of ``size`` ranks, running on ``devices``:
    its k >= 1 local devices (indexed CUDA devices, or the CPU; one device
    may be given alone).  The world has ``size k`` mesh rows, the
    reference's process-major device order: rank r holds rows ``[r k,
    (r+1) k)`` and, of P PEs, ``[r P/size, (r+1) P/size)``; ``device``, its
    first device, is where its gathered results land."""
    rank: int
    size: int
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a world of {self.size}")
        devs = self.devices
        if isinstance(devs, (str, torch.device)):
            devs = (devs,)
        devs = tuple(_row_device(d, i) for i, d in enumerate(devs))
        if not devs or len({d.type for d in devs}) > 1:
            raise ValueError(f"a rank's devices are one or more, all CUDA or all CPU, "
                             f"got {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def cards(self) -> int:
        """k, the rank's mesh rows."""
        return len(self.devices)

    @classmethod
    def from_env(cls, device=None, cards: Optional[int] = None) -> "World":
        """The world ``torchrun`` describes: ``RANK`` and ``WORLD_SIZE`` (0
        and 1 when unset).  On CUDA (unless ``device`` names the CPU or one
        card) the rank with ``LOCAL_RANK`` l takes the cards ``[l k, (l+1)
        k)``, k = ``cards`` or ``device_count // LOCAL_WORLD_SIZE`` (at
        least 1; ``LOCAL_WORLD_SIZE`` defaults to ``WORLD_SIZE``), modulo
        the card count, so ranks that outnumber the cards share them, one
        card a rank.  The CPU, or an indexed card, is one row (``cards``
        rows, if given)."""
        rank = int(os.environ.get("RANK", "0"))
        size = int(os.environ.get("WORLD_SIZE", "1"))
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)         # raises without a card
            count = torch.cuda.device_count()
            local = int(os.environ.get("LOCAL_RANK", str(rank)))
            k = cards or max(1, count // int(os.environ.get("LOCAL_WORLD_SIZE", str(size))))
            return cls(rank, size, tuple(torch.device("cuda", (local * k + j) % count)
                                         for j in range(k)))
        return cls(rank, size, (dev,) * (cards or 1))

    def pes(self, P: int) -> Tuple[int, int]:
        """The rank's PE range ``[lo, hi)`` of a ``P``-PE plan; raises
        unless the world's ``size k`` rows divide P."""
        check_rows(P, self.size * self.cards)
        ppd = P // self.size
        return self.rank * ppd, (self.rank + 1) * ppd

    def row_range(self) -> Tuple[int, int]:
        """The rank's mesh rows ``[r k, (r+1) k)`` of the world's ``size k``."""
        return self.rank * self.cards, (self.rank + 1) * self.cards

    def local(self) -> "LocalMesh":
        """The rank's rows as a :class:`LocalMesh` over its devices (a
        one-row mesh on a one-card rank, which runs the one-card path),
        made once, so that its rows' side streams are too."""
        return _local_mesh(self.devices)

    def bind(self, device=None) -> torch.device:
        """The rank's first device, made current (so that every launch,
        which goes to the current device's stream, lands there);
        ``device``, if given, must be that device."""
        if device is not None:
            d = torch.device(device)
            if d.type != self.device.type or d.index not in (None, self.device.index):
                raise ValueError(f"rank {self.rank} runs on {self.device}, not {d}")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        return self.device


class LocalMesh:
    """One process's 1-D mesh over local devices: row ``d`` runs on
    ``devices[d]`` and holds PEs ``[d P/D, (d+1) P/D)`` of a P-PE plan
    (of each segment's PEs under plan/execute overlap, as in the
    reference: ``runtime.stream_row``).

    Every device must exist (an indexed CUDA device below the card count,
    or the CPU), and the rows are all CUDA or all CPU.  The mesh is
    immutable and compares by its devices; the side streams of rows that
    share a device are made once, at their first use."""

    __slots__ = ("devices", "_streams")

    def __init__(self, devices: Sequence):
        devs = tuple(_row_device(d, i) for i, d in enumerate(devices))
        if not devs:
            raise ValueError("a local mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a local mesh's rows are all CUDA or all CPU, got {devs}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "_streams", {})

    def __setattr__(self, name, value):
        raise AttributeError("LocalMesh is immutable")

    def __eq__(self, other) -> bool:
        return isinstance(other, LocalMesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(("LocalMesh", self.devices))

    def __repr__(self) -> str:
        return f"LocalMesh({[str(d) for d in self.devices]})"

    @property
    def size(self) -> int:
        return len(self.devices)

    def pes(self, P: int, d: int) -> Tuple[int, int]:
        """Row ``d``'s PE range ``[lo, hi)`` of a ``P``-PE plan; raises
        unless the row count divides P."""
        check_rows(P, self.size)
        ppd = P // self.size
        return d * ppd, (d + 1) * ppd

    def shared(self, d: int) -> bool:
        """Whether row ``d``'s device holds another row too."""
        return self.devices.count(self.devices[d]) > 1

    def stream(self, d: int) -> Optional["torch.cuda.Stream"]:
        """Row ``d``'s CUDA stream: its device's current stream when the
        row has the device to itself, else a stream of the row's own (made
        once); ``None`` on the CPU."""
        dev = self.devices[d]
        if dev.type != "cuda":
            return None
        if not self.shared(d):
            return torch.cuda.current_stream(dev)
        s = self._streams.get(d)
        if s is None:
            s = self._streams[d] = torch.cuda.Stream(device=dev)
        return s

    @contextmanager
    def row(self, d: int) -> Iterator[torch.device]:
        """Within: row ``d``'s device is current and its stream is the
        current stream, so every allocation, copy and launch of the row's
        work lands there.  Yields the device."""
        dev = self.devices[d]
        if dev.type != "cuda":
            yield dev
            return
        s = self.stream(d)
        with torch.cuda.device(dev.index), torch.cuda.stream(s):
            yield dev

    def fence(self, d: int):
        """An event recorded now on row ``d``'s side stream (``None`` when
        the row runs on its device's current stream or on the CPU): what
        :meth:`hand_over` makes the caller wait for."""
        if self.devices[d].type != "cuda" or not self.shared(d):
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream(d))
        return ev

    def hand_over(self, d: int, fence, tensors: Sequence[torch.Tensor]) -> None:
        """Hand row ``d``'s outputs to the caller's current stream on the
        row's device: the stream waits for ``fence`` (from :meth:`fence`)
        and the tensors, allocated on the row's side stream, are marked as
        used there, so that their memory is not reused before the caller's
        work on them ends.  A no-op without a side stream."""
        if fence is None:
            return
        cur = torch.cuda.current_stream(self.devices[d])
        cur.wait_event(fence)
        for t in tensors:
            t.record_stream(cur)

    def sync(self) -> None:
        """Wait for every row's device (all its streams)."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


@functools.lru_cache(maxsize=None)
def _local_mesh(devices: Tuple[torch.device, ...]) -> LocalMesh:
    return LocalMesh(devices)


def _row_device(device, d: int) -> torch.device:
    """Mesh row ``d``'s device: the CPU or an existing CUDA device, made
    indexed (the current one when none is given); raises otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh row {d}: no device {dev} (this process sees "
                           f"{torch.cuda.device_count()} CUDA devices)")
    return dev
