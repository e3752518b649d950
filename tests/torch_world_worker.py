"""Ranks of a world of the port's generators (``repro_torch.distrib.world``)
on CPU processes, for ``tests/test_torch_world.py`` (a module of its own,
so the spawned processes import the port and not the JAX package).

Each rank reads its place from ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` as
under ``torchrun`` (:meth:`World.from_env`), runs every case of
:data:`SPECS` on its own PEs with no process group and writes its
results to ``<out>.<rank>`` with ``torch.save``.  A world of two also
joins a ``gloo`` group for one case: a slot function planted with
``all_reduce`` must be refused by ``check=True`` on every rank.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

#: the world's plans have this many PEs
P = 8
#: slots a wave row in the streams
BATCH = 2
#: one small spec a family: (class of ``repro_torch.api``, its arguments)
SPECS = {
    "gnm": ("GNM", dict(n=300, m=2000, seed=11)),
    "gnp": ("GNP", dict(n=300, p=0.03, seed=12)),
    "rgg": ("RGG", dict(n=400, radius=0.09, seed=13)),
    "rhg": ("RHG", dict(n=400, avg_deg=6.0, gamma=2.7, seed=14)),
    "rdg": ("RDG", dict(n=256, seed=15)),
    "ba": ("BA", dict(n=300, d=3, seed=16)),
    "rmat": ("RMAT", dict(log_n=8, m=3000, seed=17)),
    "sbm": ("SBM", dict(n=320, blocks=8, p_in=0.08, p_out=0.01, seed=18)),
}


def plan_fields(plan) -> dict:
    """A plan's fields but ``reseed_fn`` (numpy arrays and plain values)."""
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if f.name != "reseed_fn"}


def per_pe(chunks) -> dict:
    """``{pe: edges}`` of a stream, each PE's chunks concatenated in order."""
    out: dict = {}
    for c in chunks:
        out.setdefault(c.pe, []).append(c.edges())
    return {pe: torch.cat(es).numpy() for pe, es in out.items()}


def family_case(world, cls: str, kw: dict) -> dict:
    """What one rank gives for one spec: its edges, its plan rows, its
    wave batches on the whole plan, its streams (and, for the geometric
    families, its points)."""
    from repro_torch import api
    from repro_torch.distrib import runtime

    spec = getattr(api, cls)(**kw)
    lo, hi = world.pes(P)
    res = {"edges": api.generate(spec, P, mesh=world, device="cpu").edges.numpy(),
           "plan": plan_fields(api._plan_rows(spec, P, lo, hi, api.DEFAULT_RNG,
                                              world.device))}
    waves = []
    for w in runtime.stream_waves(spec.plan(P, device="cpu"), batch=BATCH, mesh=world,
                                  device="cpu"):
        assert w.row0 == world.rank and w.payload.shape[0] == 1
        assert all(r is None for d, r in enumerate(w.rows) if d != world.rank)
        (pe, slots, payload, valid), = w.chunks()
        waves.append((pe, np.asarray(slots).copy(), payload[valid].numpy()))
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
    return res


def planted_all_reduce_case(world, port: int) -> list:
    """On a ``gloo`` group of the world's ranks: the run and the wave
    stream of a GNM plan whose slot function also all-reduces a tensor,
    under ``check=True``; the error each raises (``None`` if none)."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.distrib import engine, runtime

    @dataclasses.dataclass(frozen=True)
    class AllReduced(engine.ChunkPlan):
        def signature(self):
            return ("all-reduced",) + super().signature()

        def slot_fn(self):
            inner = super().slot_fn()

            def rows(*tables):
                dist.all_reduce(torch.ones(1))
                return inner(*tables)
            return rows

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=world.rank, world_size=world.size)
    try:
        plan = api.GNM(n=200, m=800, seed=3).plan(P)
        planted = AllReduced(**{f.name: getattr(plan, f.name)
                                for f in dataclasses.fields(plan)})
        errors = []
        for call in (lambda: runtime.run(planted, "cpu", check=True, mesh=world),
                     lambda: list(runtime.stream_waves(planted, batch=BATCH, mesh=world,
                                                       device="cpu", check=True))):
            try:
                call()
                errors.append(None)
            except AssertionError as e:
                errors.append(str(e))
        return errors
    finally:
        dist.destroy_process_group()


def run(rank: int, size: int, out: str, port: int) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
    from repro_torch.distrib.world import World

    world = World.from_env(device="cpu")
    res = {"pes": world.pes(P),
           "families": {name: family_case(world, cls, kw)
                        for name, (cls, kw) in SPECS.items()}}
    if size == 2:
        res["planted"] = planted_all_reduce_case(world, port)
    torch.save(res, f"{out}.{rank}")


def run_on_card(rank: int, size: int, out: str) -> None:
    """A rank of a world on the card (``cuda:0`` for every rank of a
    one-card machine): the edges of GNM, SBM and RHG generated on its
    PEs, to the host."""
    from repro_torch import api
    from repro_torch.distrib.world import World

    world = World(rank, size, torch.device("cuda", 0))
    res = {}
    for name in ("gnm", "sbm", "rhg"):
        cls, kw = SPECS[name]
        res[name] = api.generate(getattr(api, cls)(**kw), P, mesh=world).edges.cpu().numpy()
    torch.save(res, f"{out}.{rank}")


def build_with(build_dir: str, nvcc: str, names) -> None:
    """``kernels.build.build(names)`` into ``build_dir`` with ``nvcc`` as
    the compiler: a process of the build-lock test."""
    from pathlib import Path

    from repro_torch.kernels import build

    build.BUILD_DIR = Path(build_dir)
    build.nvcc = lambda: nvcc
    build.build(names)
