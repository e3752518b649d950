"""Dry run of every (architecture x input shape) on the production meshes
(port of ``repro.launch.dryrun``): does the step fit, and what bounds it.

The reference lowers and compiles each cell on 512 host devices that XLA
fakes, then reads the compiled program's memory analysis and its HLO.  The
port runs each cell's step once, in one process, on a process group of the
``fake`` backend (:mod:`repro_torch.launch.mesh`: 256 ranks, or 512 with
``--multi-pod``): the parameters, the optimizer state, the batch and the
caches are DTensors placed by :mod:`repro_torch.models.shardings` whose
local shards are meta tensors (shapes, no memory; a collective of the
fake backend moves nothing), and the model's sharding hints
(:mod:`repro_torch.models.pmesh`) redistribute them as the reference's
constraints do.  :class:`repro_torch.launch.opcost.OpCost` counts what
rank 0 runs: flops, bytes, collectives and the peak of its live storages.

Run one cell:   python -m repro_torch.launch.dryrun --arch qwen3_0p6b --shape train_4k
Sweep:          python -m repro_torch.launch.sweep

The roofline prices the counts at the H100's data-sheet rates
(:data:`repro_torch.launch.roofline.H100`: matmul flops at the bf16 dense
tensor-core rate, the other flops at the float32 rate, bytes at the HBM3
bandwidth) and each mesh axis's collective bytes at its link's rate
(:func:`link_bytes_per_s`); the reference's v5e constants are not ported.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional

import torch

from ..configs import SHAPES, applicable, get_config, input_specs
from ..configs.base import ShapeSpec
from ..models import shardings as SH
from ..models import transformer as T
from ..train import optimizer as O
from ..train.train_loop import make_train_step
from . import mesh as M
from .opcost import OpCost
from .roofline import H100

# NVLink 4 within one 8-GPU HGX H100 node: 900 GB/s a GPU both ways,
# 450 GB/s a direction (NVIDIA H100 data sheet)
NVLINK_BYTES_PER_S = 450e9
# across nodes: one ConnectX-7 NDR InfiniBand port of 400 Gb/s a GPU,
# 50 GB/s a direction (NVIDIA DGX H100 data sheet)
NDR_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8


def link_bytes_per_s(mesh, axis: str) -> float:
    """The link rate of ``axis``: NVLink when its ranks lie in one 8-GPU
    node (the ranks are laid out row-major, so an axis spans its stride
    times its size), the inter-node port otherwise."""
    names = list(mesh.mesh_dim_names)
    shape = tuple(mesh.shape)
    if axis not in names:           # a group across axes: priced across nodes
        return NDR_BYTES_PER_S
    i = names.index(axis)
    span = math.prod(shape[i:])
    return NVLINK_BYTES_PER_S if span <= GPUS_PER_NODE else NDR_BYTES_PER_S


def _local_shape(shape, placements, mesh) -> list:
    from torch.distributed.tensor import Shard

    local = list(shape)
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(mdim)
    return local


def meta_dtensor(shape, dtype, spec, mesh):
    """A DTensor of global ``shape`` placed by ``spec`` whose local shard is
    a fresh meta tensor."""
    from torch.distributed.tensor import DTensor

    placements = SH.to_placements(spec, mesh)
    local = torch.empty(_local_shape(shape, placements, mesh), dtype=dtype, device="meta")
    stride = torch.empty(tuple(shape), dtype=dtype, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _params(cfg, mesh) -> T.ParamTree:
    meta = T.param_shapes(cfg)
    specs = SH.param_specs(meta, mesh, cfg)

    def walk(tree, spec):
        if isinstance(spec, dict):
            return {k: walk(tree[k], spec[k]) for k in spec}
        if isinstance(spec, list):
            return [walk(t, s) for t, s in zip(tree, spec)]
        return meta_dtensor(tuple(tree.shape), tree.dtype, spec, mesh)

    return T.ParamTree(walk(meta, specs))


def _batch(cfg, spec: ShapeSpec, mesh) -> dict:
    metas = input_specs(cfg, spec)
    specs = SH.batch_specs(cfg, mesh, metas)
    return {k: meta_dtensor(tuple(v.shape), v.dtype, specs[k], mesh) for k, v in metas.items()}


def _caches(cfg, spec: ShapeSpec, mesh, idx: int) -> list:
    metas = T.caches_init(cfg, spec.batch, spec.seq, cfg.dtype, device="meta")
    specs = SH.cache_specs(cfg, mesh, metas)
    return [{k: (idx if k == "idx" else meta_dtensor(tuple(v.shape), v.dtype, s[k], mesh))
             for k, v in layer.items()} for layer, s in zip(metas, specs)]


def build_cell(arch: str, shape, mesh, *, cfg=None, accum: Optional[int] = None):
    """``(cfg, step, state)`` of one cell: ``step()`` runs it once and
    ``state`` holds what is live before it (parameters, optimizer state,
    batch, caches).  ``shape`` is a name of ``configs.SHAPES`` or a
    ``ShapeSpec``; ``cfg`` replaces ``get_config(arch)`` (a smoke config).
    Its tensors are DTensors whose shards are meta tensors; ``step`` runs
    under the mesh's hints (:func:`run_step`)."""
    cfg = cfg if cfg is not None else get_config(arch)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    params = _params(cfg, mesh)

    if spec.kind == "train":
        accum = accum if accum is not None else int(os.environ.get("DRYRUN_ACCUM", "1"))
        opt = O.opt_init(params)
        batch = _batch(cfg, spec, mesh)
        train_step = make_train_step(cfg, O.OptConfig(), accum=accum)

        def step():
            return train_step(params, opt, batch)

        return cfg, step, (params, opt, batch)

    head = params["embed"]["head"]
    if spec.kind == "prefill":
        batch = _batch(cfg, spec, mesh)
        caches = _caches(cfg, spec, mesh, 0)

        def step():
            with torch.no_grad():
                h, _, new = T.forward(params, cfg, batch, caches=caches)
                return h[:, -1] @ head.to(h.dtype), new

        return cfg, step, (params, batch, caches)

    batch = _batch(cfg, spec, mesh)
    # one new token at the cache's last position
    caches = _caches(cfg, spec, mesh, spec.seq - 1)

    def step():
        with torch.no_grad():
            return T.decode_step(params, cfg, batch["tokens"], batch["positions"], caches)

    return cfg, step, (params, batch, caches)


def run_step(arch: str, shape, mesh, *, cfg=None, accum: Optional[int] = None):
    """``(cfg, spec, OpCost)`` of one dry-run execution of a cell's step."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    with M.hints(mesh):
        cfg, step, state = build_cell(arch, spec, mesh, cfg=cfg, accum=accum)
        cost = OpCost()
        cost.hold(state)
        with cost:
            out = step()
        del out
    return cfg, spec, cost


def axis_collective_bytes(cost: OpCost, mesh) -> dict:
    """``{axis: bytes}`` of the collectives each mesh axis carried; a
    group that is no single axis's under ``"other"``."""
    names = list(mesh.mesh_dim_names)
    group_axis = {mesh.get_group(a).group_name: a for a in names}
    out = dict.fromkeys(names, 0)
    for group, nbytes in cost.group_bytes.items():
        axis = group_axis.get(group, "other")
        out[axis] = out.get(axis, 0) + nbytes
    return out


def record(arch: str, spec: ShapeSpec, cfg, cost: OpCost, mesh, multi_pod: bool,
           seconds: float, accum: int = 1) -> dict:
    """The reference's JSON record of one cell (``dryrun.run_cell``)."""
    chips = mesh.size()
    flops_dev = cost.flops
    matmul = cost.flops_by.get("matmul", 0)
    by_axis = axis_collective_bytes(cost, mesh)
    coll_bytes = cost.collective_bytes
    tokens = spec.batch * (spec.seq if spec.kind != "decode" else 1)
    mult = 3 if spec.kind == "train" else 1  # fwd+bwd
    model_flops = 2 * cfg.active_param_count() * tokens * mult
    res = {
        "arch": arch, "shape": spec.name, "multi_pod": multi_pod, "chips": chips,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "accum": accum,
        "status": "ok", "run_s": round(seconds, 1),
        "memory": {"peak_per_device": cost.peak_bytes},
        "collectives": cost.collectives,
        "collective_bytes_by_axis": by_axis,
        "per_device": {"flops": flops_dev, "flops_by": dict(cost.flops_by),
                       "bytes": float(cost.bytes), "collective_bytes": coll_bytes},
        "roofline": {
            "compute_s": matmul / H100.ops_per_s("bf16")
            + (flops_dev - matmul) / H100.ops_per_s("fp32"),
            "memory_s": cost.bytes / H100.bytes_per_s,
            "collective_s": sum(b / link_bytes_per_s(mesh, a) for a, b in by_axis.items()),
        },
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / (flops_dev * chips) if flops_dev else None,
    }
    r = res["roofline"]
    res["dominant"] = max(r, key=r.get)
    return res


def run_cell(arch: str, shape: str, multi_pod: bool, *, mesh=None, cfg=None,
             spec: Optional[ShapeSpec] = None) -> dict:
    """One cell's record on the production mesh (or ``mesh``); ``cfg`` and
    ``spec`` replace the architecture's config and the shape (tests)."""
    cfg = cfg if cfg is not None else get_config(arch)
    spec = spec if spec is not None else SHAPES[shape]
    ok, reason = applicable(cfg, spec)
    if not ok:
        return {"arch": arch, "shape": spec.name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}
    mesh = mesh if mesh is not None else M.make_production_mesh(multi_pod=multi_pod)
    accum = int(os.environ.get("DRYRUN_ACCUM", "1"))
    t0 = time.time()
    cfg, spec, cost = run_step(arch, spec, mesh, cfg=cfg, accum=accum)
    return record(arch, spec, cfg, cost, mesh, multi_pod, time.time() - t0, accum)


def run_generator_cell(multi_pod: bool, *, n: int = 1 << 30, m: int = 1 << 34,
                       chips: Optional[int] = None, device=None) -> dict:
    """The paper's own technique on the production mesh:
    ``GNM(n=2^30, m=2^34, directed=True, seed=7)`` planned at ``P =
    chips``; one PE's program (PE 0's rows of the plan) runs once on
    ``device`` (the card unless the caller asks for the CPU) under the op
    scan, which must find no collective.  Its costs are the analytic ones
    of :mod:`repro_torch.launch.cost` for the kernels it launched."""
    from ..analyze import opscan
    from ..api import GNM
    from ..distrib import engine, runtime
    from ..kernels.build import resolve_device
    from . import cost as C

    chips = chips if chips is not None else math.prod(M.PRODUCTION[multi_pod][0])
    dev = resolve_device(device)
    t0 = time.time()
    plan = GNM(n=n, m=m, directed=True, seed=7).plan(chips)
    pe = engine.slice_plan(plan, 0, 1)
    calls: list = []
    with opscan.trace(calls=calls) as census:
        payload, valid = runtime.run(pe, device=dev, check=False)
    opscan.assert_communication_free(census)
    total = sum((C.launch_cost(name, a, k) for name, a, k in calls), C.ZERO)
    edges = int(valid.sum())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del payload, valid
    memory_s, compute_s = total.seconds(H100)
    res = {
        "arch": "kagen_er_gnm", "shape": f"n2^{n.bit_length() - 1}_m2^{m.bit_length() - 1}",
        "multi_pod": multi_pod, "chips": chips, "status": "ok",
        "run_s": round(time.time() - t0, 1), "device": dev.type,
        "launches": {k[len(opscan.KERNEL_PREFIX):]: v for k, v in census.items()
                     if k.startswith(opscan.KERNEL_PREFIX)},
        "edges_pe0": edges, "edges_pe0_plan": pe.total_edges,
        "collectives": {},
        "per_device": {"flops": total.ops, "op_kind": total.op_kind, "bytes": total.bytes,
                       "collective_bytes": 0},
        "roofline": {"compute_s": compute_s, "memory_s": memory_s, "collective_s": 0.0},
        "dominant": "memory_s" if memory_s > compute_s else "compute_s",
        "zero_collectives": True,
    }
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the generator cell's device (cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.arch == "kagen_er_gnm":
        res = run_generator_cell(args.multi_pod, device=args.device)
    else:
        res = run_cell(args.arch, args.shape, args.multi_pod)
    js = json.dumps(res, indent=1, default=str)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    return 0


if __name__ == "__main__":
    sys.exit(main())
