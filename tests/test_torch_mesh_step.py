"""The port's LM under a device mesh (``repro_torch.models.pmesh``,
``shardings``, ``launch/mesh.py``) on the CPU: a ``gloo`` world of four
spawned processes (``tests/torch_mesh_worker.py``).

* the sharded train step of qwen3's smoke config on a 2 x 2 mesh equals
  the single-device step within ``tests/torch_train_tol.py``'s bounds
  (the reference's own sharded step does not match its single-device
  one: ``tests/test_distrib_lm.py``);
* the grouped MoE dispatch (G = 4 groups on a 4 x 1 mesh) equals the
  reference's ``moe`` under a 4 x 1 mesh of forced host devices;
* ``cache_write``'s two branches (in place, and the masked single-token
  write under mesh hints) give the same cache;
* ``launch/train.py --model-mesh 2`` under ``torchrun`` ends with the
  single-process run's loss.

Each case's processes run under a time limit of their own.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_train_tol import LOSS_ABS, step_errors
import torch_mesh_worker as W

from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import pmesh
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(case: str, args: tuple, world: int = 4, limit: float = 300.0):
    """Run ``torch_mesh_worker.run`` on ``world`` spawned ranks; rank 0's
    result, or a failure past ``limit`` seconds."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.pt")
        ctx = torch.multiprocessing.start_processes(
            W.run, args=(world, _free_port(), out, case, args), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + limit
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    pytest.fail(f"{case} on {world} ranks: no result within {limit:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return torch.load(out, weights_only=False)


def _sharded_against_single(arch: str, vocab=None) -> None:
    got = _spawn("train_step", (arch, (2, 2), vocab))
    cfg = get_smoke_config(arch)
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    params = T.model_init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    step = make_train_step(cfg, O.OptConfig(**W.OPT))
    params, opt, metrics = step(params, O.opt_init(params), W.smoke_batch(cfg))
    errs = step_errors(got["params"], got["m"], got["metrics"],
                       dict(params.named_parameters()), opt["m"], metrics)
    assert max(errs.values()) <= 1


def test_sharded_train_step_matches_single_device():
    _sharded_against_single("qwen3_0p6b")


def test_sharded_train_step_with_an_unsplit_vocabulary_matches_single_device():
    """A vocabulary the model axis does not divide (255 over 2) stays whole
    on each rank: the loss's target logit is the gather's path."""
    _sharded_against_single("qwen3_0p6b", vocab=255)


REF_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models import layers as L, pmesh

data = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "model"))
out = {}
for arch in sys.argv[3].split(","):
    cfg = get_smoke_config(arch)
    w = {k.split("/", 1)[1]: jnp.asarray(data[k]) for k in data.files if k.startswith(arch + "/")}
    p = {k: w[k] for k in ("router", "w_gate", "w_up", "w_down")}
    if "shared.w_gate" in w:
        p["shared"] = {k: w["shared." + k] for k in ("w_gate", "w_up", "w_down")}
    with mesh, pmesh.use_hints(mesh):
        y, aux = jax.jit(lambda p, x: L.moe(p, cfg, x))(p, w["x"])
    out[arch + "/y"], out[arch + "/aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def test_grouped_moe_matches_reference_under_mesh(tmp_path):
    archs = ("mixtral_8x7b", "deepseek_v2_lite_16b")
    rng = np.random.default_rng(5)
    weights, cfgs, flat = {}, {}, {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        cfgs[arch] = cfg
        shapes = L.moe_init(cfg, device="meta")
        w = {}
        for k, v in shapes.items():
            if isinstance(v, dict):
                w.update({f"{k}.{kk}": (rng.standard_normal(tuple(vv.shape)) * 0.05
                                        ).astype(np.float32) for kk, vv in v.items()})
            else:
                w[k] = (rng.standard_normal(tuple(v.shape)) * 0.05).astype(np.float32)
        w["x"] = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
        weights[arch] = w
        flat.update({f"{arch}/{k}": v for k, v in w.items()})
    np.savez(tmp_path / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REF_MOE, str(tmp_path / "in.npz"),
                        str(tmp_path / "ref.npz"), ",".join(archs)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    got = _spawn("moe", (weights, cfgs))
    for arch in archs:
        y, aux = got[arch]
        want = ref[arch + "/y"]
        assert y.shape == want.shape
        scale = float(np.abs(want).max())
        assert float(np.abs(y - want).max()) <= 1e-5 * scale, arch
        assert abs(aux - float(ref[arch + "/aux"])) <= 1e-6, arch


DECODE_CASES = [(4, 2, 0, False), (4, 1, 0, False), (8, 2, 6, True)]


def test_decode_attention_under_mesh_hints_matches_one_process():
    """The grouped decode attention on a 2 x 2 mesh, q's heads and the
    cache's positions sharded over the model axis: kv heads split over it
    (KV 2), kept whole (KV 1), a sliding-window ring cache; each equals
    the one-process result."""
    got = _spawn("decode_attention", (DECODE_CASES,))
    for case, y, (q, k, v, H, hd, kw) in zip(DECODE_CASES, got,
                                               W.decode_inputs(DECODE_CASES)):
        want = L._sdpa_decode(q, k, v, hd, H, **kw).numpy()
        assert y.shape == want.shape, case
        assert float(np.abs(y - want).max()) <= 1e-6 * float(np.abs(want).max()), case


@pytest.mark.parametrize("S", [1, 3])
def test_cache_write_branches_agree(S):
    g = torch.Generator().manual_seed(S)
    cache = torch.randn((2, 8, 2, 4), generator=g)
    new = torch.randn((2, S, 2, 4), generator=g)
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    for idx in (0, 2, 8 - S, 9):
        want = L.cache_write(cache.clone(), new, idx)
        with pmesh.use_hints(stand_in):
            got = L.cache_write(cache.clone(), new, idx)
        assert torch.equal(got, want), idx


def _final_loss(stdout: str) -> float:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("final loss ")]
    assert lines, stdout[-2000:]
    return float(lines[-1].split()[-1])


def test_launch_train_model_mesh_matches_single_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    common = ["-m", "repro_torch.launch.train", "--device", "cpu", "--smoke", "--steps", "2"]
    one = subprocess.run([sys.executable, *common, "--ckpt-dir", str(tmp_path / "one")],
                         capture_output=True, text=True, timeout=600, env=env)
    assert one.returncode == 0, one.stderr[-3000:]
    mesh = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                           "4", "--master-addr", "127.0.0.1", "--master-port",
                           str(_free_port()), *common, "--model-mesh", "2",
                           "--ckpt-dir", str(tmp_path / "mesh")],
                          capture_output=True, text=True, timeout=600, env=env)
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    assert abs(_final_loss(mesh.stdout) - _final_loss(one.stdout)) <= LOSS_ABS


def test_launch_train_refuses_multihost_and_a_bare_model_mesh(tmp_path):
    from repro_torch.launch import train
    for argv in (["--multihost"], ["--model-mesh", "2"]):
        with pytest.raises(SystemExit):
            train.main(["--device", "cpu", "--smoke", "--ckpt-dir", str(tmp_path), *argv])
