"""Production meshes (port of ``repro.launch.mesh``).  Functions, never
run at import, so importing this module touches no process group.

The reference lowers on host devices that XLA fakes; the port's
counterpart is a process group of the ``fake`` backend (PyTorch's
``FakeStore``): every collective returns at once, so a 256- or 512-rank
mesh exists in one process, and with meta tensors as its shards nothing
is allocated (:mod:`repro_torch.launch.dryrun`).  Under ``torchrun``
(a real group of the mesh's size) the same functions build the mesh on
that group.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def ensure_group(world: int) -> None:
    """A process group of ``world`` ranks: the fake backend at rank 0 if
    none exists; raises if a group of another size is active."""
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world:
            raise RuntimeError(f"a process group of {have} ranks is active; this mesh needs "
                               f"{world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _device_type() -> str:
    """The mesh's device type: ``cpu`` on the fake backend (its tensors are
    fake), the group's device under a real backend."""
    if dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on the active group (the
    fake one of that size if there is none)."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_group(math.prod(shape))
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 pods x
    256 = 512 ranks (pod, data, model)."""
    return make_mesh(*PRODUCTION[multi_pod])


def make_debug_mesh(n_data: int = 2, n_model: int = 2):
    """A small (data, model) mesh for tests."""
    return make_mesh((n_data, n_model), ("data", "model"))


def reset() -> None:
    """Destroy the active process group (a dry run of another mesh size
    follows in the same process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def hints(mesh):
    """The model's sharding hints on ``mesh`` with plain tensors (masks,
    positions, scalars every rank computes whole) taken as replicated; a
    null context for no mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import pmesh

    stack = contextlib.ExitStack()
    stack.enter_context(pmesh.use_hints(mesh))
    stack.enter_context(implicit_replication())
    return stack


def shard_state(params, opt, mesh):
    """The parameters (a ``ParamTree``) and the optimizer's moments as
    DTensors placed by :func:`repro_torch.models.shardings.leaf_spec`:
    every rank holds the same whole tensors and keeps its shards."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.shardings import leaf_spec, to_placements
    from ..models.transformer import ParamTree

    def shard(name, t):
        spec = leaf_spec(name.rsplit(".", 1)[-1], tuple(t.shape), mesh)
        return distribute_tensor(t.detach(), mesh, to_placements(spec, mesh))

    def tree(t, prefix=""):
        if isinstance(t, (dict, ParamTree)):
            return {k: tree(v, f"{prefix}{k}.") for k, v in t.items()}
        if isinstance(t, (list, torch.nn.ModuleList)):
            return [tree(v, f"{prefix}{i}.") for i, v in enumerate(t)]
        return shard(prefix[:-1], t)

    moments = {k: {n: shard(n, v) for n, v in opt[k].items()} for k in ("m", "v")}
    return ParamTree(tree(params)), dict(moments, step=opt["step"])


def shard_batch(cfg, batch: dict, mesh, device) -> dict:
    """A batch (arrays every rank holds whole) as DTensors placed by
    :func:`repro_torch.models.shardings.batch_specs`."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.shardings import batch_specs, to_placements

    tensors = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    specs = batch_specs(cfg, mesh, tensors)
    return {k: distribute_tensor(v, mesh, to_placements(specs[k], mesh))
            for k, v in tensors.items()}


def whole(t):
    """A DTensor's whole value (a collective: every rank calls it); any
    other value as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def whole_state(params, opt) -> dict:
    """``{"params", "opt"}`` of whole tensors, named as one process's
    checkpoint names them (a collective)."""
    return {"params": {k: whole(p) for k, p in params.named_parameters()},
            "opt": {"m": {k: whole(v) for k, v in opt["m"].items()},
                    "v": {k: whole(v) for k, v in opt["v"].items()},
                    "step": whole(opt["step"])}}
