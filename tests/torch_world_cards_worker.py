"""Ranks of a world whose every rank owns two mesh rows (two CPU rows
here; several cards a rank on a host with more cards than ranks), for
``tests/test_torch_world_cards.py``: a module of its own, so the spawned
processes import the port and not the JAX package.

Each rank reads its place from ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` as
under ``torchrun`` (:meth:`World.from_env` with ``cards=2``), runs every
family of ``torch_world_worker.SPECS`` on its own PEs over its two rows
with no process group, and writes its results to ``<out>.<rank>`` with
``torch.save``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from torch_world_worker import BATCH, P, SPECS, per_pe

#: mesh rows a rank owns
CARDS = 2


def family_case(world, cls: str, kw: dict, rows_used: set) -> dict:
    """What one rank gives for one spec: its edges (and the rows that ran
    them), its wave batches by world row, its streams, its points and the
    names of its contract-scan cases."""
    from repro_torch import api
    from repro_torch.distrib import runtime

    spec = getattr(api, cls)(**kw)
    r0, r1 = world.row_range()
    rows_used.clear()
    res = {"edges": api.generate(spec, P, mesh=world, device="cpu").edges.numpy(),
           "generate_rows": sorted(rows_used)}
    waves = {d: [] for d in range(r0, r1)}
    for w in runtime.stream_waves(spec.plan(P, device="cpu"), batch=BATCH, mesh=world,
                                  device="cpu"):
        assert w.row0 == r0 and len(w.rows) == world.size * world.cards
        assert all(r is None for d, r in enumerate(w.rows) if not r0 <= d < r1)
        assert isinstance(w.payload, tuple) and len(w.payload) == world.cards
        for d, row in enumerate(w.rows):
            if row is not None:
                pe, slots = row
                payload, valid = w.payload[d - r0], w.valid[d - r0]
                waves[d].append((pe, np.asarray(slots).copy(), payload[valid].numpy()))
    res["waves"] = waves
    res["chunks"] = per_pe(api.iter_edge_chunks(spec, P, mesh=world, device="cpu",
                                                batch=BATCH, check=True))
    res["overlap"] = per_pe(api.iter_edge_chunks(spec, P, mesh=world, device="cpu",
                                                 overlap=2))
    if hasattr(spec, "point_plan"):
        g = api.generate(spec, P, mesh=world, device="cpu", return_points=True)
        res["points"] = g.points.numpy()
        res["iter_points"] = [(c.pe, c.points().numpy())
                              for c in api.iter_points(spec, P, mesh=world, device="cpu")]
    res["contracts"] = sorted(r.name for r in api.verify_contracts(spec, P, mesh=world,
                                                                   device="cpu"))
    return res


def run(rank: int, size: int, out: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size))
    from repro_torch.distrib.world import LocalMesh, World

    rows_used: set = set()
    real = LocalMesh.row

    def row(self, d):
        rows_used.add(d)
        return real(self, d)

    LocalMesh.row = row
    world = World.from_env(device="cpu", cards=CARDS)
    res = {"pes": world.pes(P), "rows": world.row_range(),
           "devices": [str(d) for d in world.devices],
           "families": {name: family_case(world, cls, kw, rows_used)
                        for name, (cls, kw) in SPECS.items()}}
    torch.save(res, f"{out}.{rank}")


def run_on_card(rank: int, size: int, out: str) -> None:
    """A rank of two rows on ``cuda:0`` (a one-card machine): the edges of
    GNM, SBM and RHG generated on its PEs, and its SBM stream by PE, to
    the host."""
    from repro_torch import api
    from repro_torch.distrib.world import World

    world = World(rank, size, [torch.device("cuda", 0)] * CARDS)
    res = {}
    for name in ("gnm", "sbm", "rhg"):
        cls, kw = SPECS[name]
        res[name] = api.generate(getattr(api, cls)(**kw), P, mesh=world).edges.cpu().numpy()
    cls, kw = SPECS["sbm"]
    stream: dict = {}
    for c in api.iter_edge_chunks(getattr(api, cls)(**kw), P, mesh=world, batch=BATCH):
        stream.setdefault(c.pe, []).append(c.edges().cpu())
    res["sbm_stream"] = {pe: torch.cat(es).numpy() for pe, es in stream.items()}
    torch.save(res, f"{out}.{rank}")
