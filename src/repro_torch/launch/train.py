"""Production training driver (port of ``repro.launch.train``).

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0p6b --steps 100

On the CPU (the kernels' plain versions), at a smoke config:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 4

Batches come from ``make_global_batch`` (graph walks on ``rhg_walk``,
sequences of 256, four a shard, seed 11), ``--data-mesh`` shards of it on
the one device.  The run resumes from the latest checkpoint in
``--ckpt-dir``, saves every ``--ckpt-every`` steps in the background and
at the end.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from ..configs import get_config, get_smoke_config
from ..data import pipeline as D
from ..kernels.build import resolve_device
from ..models import transformer as T
from ..train import checkpoint as CK
from ..train import optimizer as O
from ..train.train_loop import make_train_step


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
                    help="model-parallel ways: only 1 (meshes are ROADMAP item 10e)")
    ap.add_argument("--multihost", action="store_true",
                    help="not supported by the port (ROADMAP item 10e)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.model_mesh != 1 or args.multihost:
        ap.error("--model-mesh other than 1 and --multihost need a device mesh, which the port "
                 "does not have yet (ROADMAP item 10e)")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dc = data_config(cfg, args.data_mesh or 1)
    opt_cfg = O.OptConfig(total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, accum=args.accum)

    params = T.model_init(cfg, device=dev)
    opt = O.opt_init(params)
    state = {"params": params, "opt": opt}
    start = CK.latest_step(args.ckpt_dir) or 0
    if start:
        CK.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    pending = None
    t0 = time.time()
    for s in range(start, args.steps):
        batch = D.make_global_batch(dc, s, device=dev)
        params, opt, metrics = step_fn(params, opt, batch)
        state = {"params": params, "opt": opt}
        if s % 10 == 0:
            print(f"step {s} loss {float(metrics['loss']):.4f} "
                  f"({(s - start + 1) / (time.time() - t0):.2f} it/s)", flush=True)
        if (s + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = CK.save(args.ckpt_dir, s + 1, state, meta={"arch": cfg.name},
                              background=True)
    if pending is not None:
        pending.join()
    CK.save(args.ckpt_dir, args.steps, state, meta={"arch": cfg.name})
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
