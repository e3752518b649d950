"""Ranks of the port's meshes on a ``gloo`` world of CPU processes, for
``tests/test_torch_mesh_step.py`` (a module of its own, so the spawned
processes import the port and not the JAX package).

Each worker joins ``tcp://127.0.0.1:<port>`` as ``rank`` of ``world``,
runs its case and rank 0 writes the whole results to ``out`` with
``torch.save``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

#: the sharded step's optimizer: a learning rate that moves the masters
OPT = dict(lr=1e-3, warmup=5, total_steps=200)


def smoke_batch(cfg, B: int = 4, S: int = 32, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "positions": np.tile(np.arange(S, dtype=np.int32), (B, 1))}


def train_step_case(arch: str, mesh_shape, vocab=None) -> dict:
    """One ``make_train_step`` step of ``arch``'s smoke config (with
    ``vocab`` if given) from seeded masters, sharded on a ("data",
    "model") mesh of ``mesh_shape``: the whole masters, ``m`` and metrics
    after it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    mesh = M.make_mesh(mesh_shape, ("data", "model"))
    cfg = get_smoke_config(arch)
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    params = T.model_init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    params, opt = M.shard_state(params, O.opt_init(params), mesh)
    batch = M.shard_batch(cfg, smoke_batch(cfg), mesh, "cpu")
    step = make_train_step(cfg, O.OptConfig(**OPT))
    with M.hints(mesh):
        params, opt, metrics = step(params, opt, batch)
        state = M.whole_state(params, opt)
        mets = {k: float(M.whole(v)) for k, v in metrics.items()}
    return {"params": state["params"], "m": state["opt"]["m"], "metrics": mets}


def moe_case(weights: dict, cfgs: dict) -> dict:
    """``layers.moe`` of each config on its weights and input (numpy
    arrays) under the hints of a (world, 1) mesh: its dispatch runs in
    ``world`` groups."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L

    mesh = M.make_mesh((dist.get_world_size(), 1), ("data", "model"))
    out = {}
    for name, cfg in cfgs.items():
        w = {k: torch.from_numpy(v) for k, v in weights[name].items()}
        p = {k: w[k] for k in ("router", "w_gate", "w_up", "w_down")}
        if "shared.w_gate" in w:
            p["shared"] = {k: w["shared." + k] for k in ("w_gate", "w_up", "w_down")}
        with M.hints(mesh):
            y, aux = L.moe(p, cfg, w["x"])
            out[name] = (M.whole(y).numpy(), float(M.whole(aux)))
    return out


def decode_attention_case(cases) -> list:
    """``layers._sdpa_decode`` of seeded q [B, 1, H, hd] against a cache
    [B, T, KV, hd] under the hints of a 2 x 2 ("data", "model") mesh, q's
    heads and the cache's positions sharded over the model axis (as the
    cache specs place a decode cache): the whole output of each case
    ``(H, KV, window, ring)``, for the one-process result to be held
    against."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import pmesh

    mesh = M.make_mesh((2, 2), ("data", "model"))
    out = []
    for q, k, v, H, hd, kw in decode_inputs(cases):
        with M.hints(mesh):
            qd = pmesh.constrain(q, "dp", None, "tp", None)
            kd, vd = (pmesh.constrain(x, "dp", "tp", None, None) for x in (k, v))
            out.append(M.whole(L._sdpa_decode(qd, kd, vd, hd, H, **kw)).numpy())
    return out


def decode_inputs(cases):
    """Seeded ``(q, k, v, H, hd, keywords)`` of each decode attention case."""
    g = torch.Generator().manual_seed(5)
    B, T, hd = 4, 16, 8
    for H, KV, window, ring in cases:
        q = torch.randn((B, 1, H, hd), generator=g)
        k, v = (torch.randn((B, T, KV, hd), generator=g) for _ in range(2))
        kw = {"window": window, "q_offset": T + 3 if ring else T - 1}
        if ring:     # slot r of a ring holds position idx - ((idx % T - r) mod T)
            kw["key_pos"] = kw["q_offset"] - torch.remainder(kw["q_offset"] % T
                                                             - torch.arange(T), T)
        yield q, k, v, H, hd, kw


CASES = {"train_step": train_step_case, "moe": moe_case,
         "decode_attention": decode_attention_case}


def run(rank: int, world: int, port: int, out: str, case: str, args: tuple) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        res = CASES[case](*args)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()
