"""Generate one spec: in one process over the local cards, or rank by
rank, every process of a ``torchrun`` world generating its own PEs, with
no process group and nothing exchanged.

One process over the host's cards (the reference's default mesh,
``runtime.mesh_for(P)``: the most cards that divide P):
    python -m repro_torch.launch.generate GNM n=16777216 m=268435456 seed=1 --pes 16

On the cards of one host, ranks of several cards each (8 cards, 2 ranks:
cards 0-3 and 4-7, ``device_count // LOCAL_WORLD_SIZE`` a rank):
    torchrun --nproc-per-node 2 -m repro_torch.launch.generate GNM n=16777216 m=268435456 \\
        seed=1 --pes 16

On the CPU (the kernels' plain versions):
    torchrun --nproc-per-node 2 -m repro_torch.launch.generate --device cpu RGG n=100000 \\
        radius=0.01 seed=4 --pes 8 --out /tmp/rgg

Without ``torchrun`` (no ``WORLD_SIZE`` in the environment) the process
spreads the P PEs over ``mesh_for(P)``'s cards
(:class:`repro_torch.distrib.world.LocalMesh`; ``--device`` names one
device instead), gathers the edges on the first and prints one line:
the mesh, the edge count, the wall and an order-sensitive digest.  Under
``torchrun`` rank ``r`` of K generates PEs ``[r P/K, (r+1) P/K)`` over its
own cards (:class:`repro_torch.distrib.world.World`), gathers them on its
first card and prints that line for its PEs.  With ``--out DIR`` each process writes its edges to
``DIR/edges.<rank>.npy`` (rank 0 without ``torchrun``); the files
concatenated in rank order are ``generate(spec, P).edges`` of one
process.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import os
import sys
import time

import numpy as np
import torch

from .. import api
from ..distrib import runtime
from ..distrib.world import LocalMesh, World

FAMILIES = ("GNM", "GNP", "RGG", "RHG", "RDG", "BA", "RMAT", "SBM")


def parse_spec(family: str, params) -> object:
    """``family`` (a spec class of :mod:`repro_torch.api`) built from
    ``key=value`` strings, each value a Python literal."""
    if family not in FAMILIES:
        raise SystemExit(f"unknown family {family!r}: one of {', '.join(FAMILIES)}")
    kw = {}
    for p in params:
        key, sep, value = p.partition("=")
        if not sep:
            raise SystemExit(f"want key=value, got {p!r}")
        kw[key] = ast.literal_eval(value)
    return getattr(api, family)(**kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.generate",
                                 description="Generate a spec over the local cards, or "
                                             "its PEs on each rank of a world.")
    ap.add_argument("family", help=", ".join(FAMILIES))
    ap.add_argument("params", nargs="*", help="the spec's fields as key=value")
    ap.add_argument("--pes", type=int, default=16, help="P, a multiple of the world's size")
    ap.add_argument("--device", default=None,
                    help="cpu, or one card; by default every local card that divides "
                         "--pes (under torchrun, the rank's share of the host's cards)")
    ap.add_argument("--out", default=None, help="write each process's edges here")
    args = ap.parse_args(argv)
    spec = parse_spec(args.family, args.params)
    if "WORLD_SIZE" in os.environ:
        mesh = World.from_env(device=args.device)
        dev, devices, rank = mesh.device, mesh.devices, mesh.rank
        (lo, hi), where = mesh.pes(args.pes), f"rank {mesh.rank} of {mesh.size}"
    else:
        mesh, dev = runtime.placement(args.pes, None, args.device)
        devices = mesh.devices if isinstance(mesh, LocalMesh) else (dev,)
        rank, (lo, hi), where = 0, (0, args.pes), "one process"
    t0 = time.perf_counter()
    edges = api.generate(spec, args.pes, mesh=mesh, device=dev).edges
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    host = np.ascontiguousarray(edges.cpu().numpy(), "<i8")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, f"edges.{rank}.npy"), host)
    print(f"{where} on {', '.join(map(str, devices))}: PEs [{lo}, {hi}) of {args.pes}, "
          f"{len(host)} edges in {wall:.3f}s, "
          f"sha256 {hashlib.sha256(host.tobytes()).hexdigest()[:16]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
