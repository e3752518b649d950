"""A world of ranks that generate their own PEs with no collective (the
port of the reference's multi-device and multi-process ``mesh=``).

The reference spreads P virtual PEs over a mesh of D devices, possibly
in several processes (``jax.make_mesh``): mesh row ``d`` holds PEs
``[d P/D, (d+1) P/D)``, each process builds and executes only the rows
it can address, and ``Wave.rows`` is ``None`` for the others.  The port
runs one rank a process and one card a rank: a :class:`World` names the
rank, the world's size and the rank's device, and every entry point that
takes ``mesh=world`` plans, uploads and executes only the rank's PEs.

Generation needs no process group: every PE's output is a pure function
of ``(spec, P, pe)``, so a rank never waits on another and nothing is
exchanged.  Gathering the ranks' results is the caller's own business
(concatenating the ranks' edges in rank order gives the one-process
edges, bit for bit).

    >>> w = World(rank=1, size=2, device="cpu")
    >>> w.pes(8)
    (4, 8)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import torch

from ..kernels.build import resolve_device


def check_rows(P: int, D: int) -> None:
    """Raise unless ``D`` mesh rows can shard ``P`` PEs."""
    if D < 1 or P % D:
        raise ValueError(f"mesh of {D} devices cannot shard a {P}-PE plan: "
                         f"P % devices must be 0")


@dataclass(frozen=True)
class World:
    """Rank ``rank`` of a world of ``size`` ranks, running on ``device``
    (an indexed CUDA device, or the CPU).  Rank ``d`` is the reference's
    mesh row ``d``: of P PEs it generates ``[d P/size, (d+1) P/size)``."""
    rank: int
    size: int
    device: torch.device

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a world of {self.size}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @classmethod
    def from_env(cls, device=None) -> "World":
        """The world ``torchrun`` describes: ``RANK`` and ``WORLD_SIZE``
        (0 and 1 when unset), on ``cuda:{LOCAL_RANK % device_count}``
        unless ``device`` asks for the CPU."""
        rank = int(os.environ.get("RANK", "0"))
        size = int(os.environ.get("WORLD_SIZE", "1"))
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)         # raises without a card
            local = int(os.environ.get("LOCAL_RANK", str(rank)))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        return cls(rank, size, dev)

    def pes(self, P: int) -> Tuple[int, int]:
        """The rank's PE range ``[lo, hi)`` of a ``P``-PE plan; raises
        unless the world's size divides P."""
        check_rows(P, self.size)
        ppd = P // self.size
        return self.rank * ppd, (self.rank + 1) * ppd

    def bind(self, device=None) -> torch.device:
        """The rank's device, made current (so that every launch, which
        goes to the current device's stream, lands there); ``device``, if
        given, must be the world's."""
        if device is not None:
            d = torch.device(device)
            if d.type != self.device.type or d.index not in (None, self.device.index):
                raise ValueError(f"rank {self.rank} runs on {self.device}, not {d}")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        return self.device
