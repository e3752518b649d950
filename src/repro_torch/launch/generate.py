"""Generate one spec rank by rank: every process of a ``torchrun`` world
generates its own PEs, with no process group and nothing exchanged.

On the cards of one host, one rank a card:
    torchrun --nproc-per-node 4 -m repro_torch.launch.generate GNM n=16777216 m=268435456 \\
        seed=1 --pes 16

On the CPU (the kernels' plain versions):
    torchrun --nproc-per-node 2 -m repro_torch.launch.generate --device cpu RGG n=100000 \\
        radius=0.01 seed=4 --pes 8 --out /tmp/rgg

Rank ``d`` of K generates PEs ``[d P/K, (d+1) P/K)``
(:class:`repro_torch.distrib.world.World`) and prints one line: its PEs,
its edge count, its wall and an order-sensitive digest of its edges.
With ``--out DIR`` it writes its edges to ``DIR/edges.<rank>.npy``; the
files concatenated in rank order are ``generate(spec, P).edges`` of one
process.  Without ``torchrun`` it is a world of one.
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
from ..distrib.world import World

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
                                 description="Generate a spec's PEs on each rank of a world.")
    ap.add_argument("family", help=", ".join(FAMILIES))
    ap.add_argument("params", nargs="*", help="the spec's fields as key=value")
    ap.add_argument("--pes", type=int, default=16, help="P, a multiple of the world's size")
    ap.add_argument("--device", default=None, help="cpu, or a card a rank (the default)")
    ap.add_argument("--out", default=None, help="write each rank's edges here")
    args = ap.parse_args(argv)
    spec = parse_spec(args.family, args.params)
    world = World.from_env(device=args.device)
    t0 = time.perf_counter()
    edges = api.generate(spec, args.pes, mesh=world).edges
    if world.device.type == "cuda":
        torch.cuda.synchronize(world.device)
    wall = time.perf_counter() - t0
    host = np.ascontiguousarray(edges.cpu().numpy(), "<i8")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, f"edges.{world.rank}.npy"), host)
    lo, hi = world.pes(args.pes)
    print(f"rank {world.rank} of {world.size} on {world.device}: PEs [{lo}, {hi}) of "
          f"{args.pes}, {len(host)} edges in {wall:.3f}s, sha256 "
          f"{hashlib.sha256(host.tobytes()).hexdigest()[:16]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
