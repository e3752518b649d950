"""Production training driver (port of ``repro.launch.train``).

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0p6b --steps 100

On the CPU (the kernels' plain versions), at a smoke config:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 4

On a mesh of ``torchrun``'s processes (``gloo`` on the CPU, ``nccl`` on
cards; one host), ``(world / N, N)`` ranks on ("data", "model"):
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu --smoke --model-mesh 2

Batches come from ``make_global_batch`` (graph walks on ``rhg_walk``,
sequences of 256, four a shard, seed 11), ``--data-mesh`` shards of it on
the one device.  Under ``--model-mesh`` every rank builds the same
parameters and batches, keeps its shards of them
(:mod:`repro_torch.models.shardings`) and steps under the model's
sharding hints (:mod:`repro_torch.models.pmesh`).  The run resumes from
the latest checkpoint in ``--ckpt-dir``, saves every ``--ckpt-every``
steps in the background and at the end (under a mesh: the whole tensors,
gathered, written by rank 0).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..configs import get_config, get_smoke_config
from ..data import pipeline as D
from ..kernels.build import resolve_device
from ..models import transformer as T
from ..train import checkpoint as CK
from ..train import optimizer as O
from ..train.train_loop import make_train_step
from . import mesh as M


def data_config(cfg, shards: int = 1) -> D.DataConfig:
    """The driver's batches: graph walks on ``rhg_walk`` in ``cfg``'s
    vocabulary, sequences of 256, four a shard, seed 11."""
    return D.DataConfig(kind="rhg_walk", vocab=cfg.vocab, seq_len=256,
                        batch_per_shard=4, num_shards=shards, seed=11)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description="Train an architecture on generated graph walks.")
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data shards of each batch, all on the one device (0: one a device)")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="model-parallel ways N: a (world / N, N) mesh of torchrun's processes")
    ap.add_argument("--multihost", action="store_true",
                    help="not supported by the port: it runs on one host")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.multihost:
        ap.error("--multihost: the port runs its meshes on one host (torchrun's processes); "
                 "it has no launcher for processes across hosts")

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.model_mesh != 1 and ("RANK" not in os.environ or world % args.model_mesh):
        ap.error(f"--model-mesh {args.model_mesh} needs torchrun with a world size it "
                 f"divides (WORLD_SIZE {world})")
    dev = resolve_device(args.device)
    mesh = None
    if args.model_mesh != 1:
        mesh, dev = _mesh(world, args.model_mesh, dev)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dc = data_config(cfg, args.data_mesh or 1)
    opt_cfg = O.OptConfig(total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum)

    params = T.model_init(cfg, device=dev)
    opt = O.opt_init(params)
    start = CK.latest_step(args.ckpt_dir) or 0
    if start:
        CK.restore(args.ckpt_dir, {"params": params, "opt": opt})
    if mesh is not None:
        params, opt = M.shard_state(params, opt, mesh)
    if start and rank0:
        print(f"resumed from step {start}")

    pending = None
    t0 = time.time()
    with M.hints(mesh):
        for s in range(start, args.steps):
            batch = D.make_global_batch(dc, s, device=dev)
            if mesh is not None:
                batch = M.shard_batch(cfg, batch, mesh, dev)
            params, opt, metrics = step_fn(params, opt, batch)
            if s % 10 == 0 or s == args.steps - 1:
                loss = float(M.whole(metrics["loss"]))   # every rank: a collective on a mesh
            if s % 10 == 0 and rank0:
                print(f"step {s} loss {loss:.4f} "
                      f"({(s - start + 1) / (time.time() - t0):.2f} it/s)", flush=True)
            if (s + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = _save(args.ckpt_dir, s + 1, params, opt, cfg, mesh, background=True)
    if pending is not None:
        pending.join()
    _save(args.ckpt_dir, args.steps, params, opt, cfg, mesh)
    if rank0:
        if args.steps > start:
            print(f"final loss {loss:.8f}")
        print("done")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


def _mesh(world: int, n_model: int, dev):
    """The (world / N, N) ("data", "model") mesh of torchrun's processes:
    ``gloo`` on the CPU, ``nccl`` on the cards (one a local rank)."""
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return M.make_mesh((world // n_model, n_model), ("data", "model")), dev


def _save(ckpt_dir, step, params, opt, cfg, mesh, background=False):
    """Save ``{"params", "opt"}``; under a mesh the whole tensors, gathered
    on every rank and written by rank 0 (the leaves are named as one
    process's are)."""
    if mesh is None:
        return CK.save(ckpt_dir, step, {"params": params, "opt": opt},
                       meta={"arch": cfg.name}, background=background)
    state = M.whole_state(params, opt)
    out = None
    if torch.distributed.get_rank() == 0:
        out = CK.save(ckpt_dir, step, state, meta={"arch": cfg.name}, background=background)
    torch.distributed.barrier()
    return out


if __name__ == "__main__":
    sys.exit(main())
