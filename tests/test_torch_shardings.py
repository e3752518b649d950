"""The port's sharding rules (``repro_torch.models.shardings``) against the
reference's (``repro.models.shardings``), leaf by leaf, for the ten
architectures at full width on the (16, 16), (2, 16, 16) and (4, 2)
meshes.

The reference's rule functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so both get a stand-in with those fields and no
device state.  The reference's stacked body leaves ``P(None, *fixed)`` map
onto the port's per-layer ``fixed`` through
``repro_torch.models.convert.unstack_layers``.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

import repro  # noqa: F401  (x64 before any jax dtype)
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config, input_specs as ref_inputs
from repro.configs import applicable as ref_applicable
from repro.models import shardings as RSH
from repro.models import transformer as RT
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config, input_specs
from repro_torch.models import convert
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def stand_in(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=np.int8))


class _Stacked:
    """A reference spec of a stacked body leaf: indexing a layer drops
    the leading (stacked) entry."""

    def __init__(self, spec):
        self.spec = spec

    def __getitem__(self, r):
        return tuple(self.spec)[1:]


def _plain(x):
    """Spec trees with tuple leaves: the reference's ``P`` as a tuple."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, _Stacked):
        return tuple(x.spec)
    if isinstance(x, P):
        return tuple(x)
    return x


def _ref_per_layer(tree, cfg):
    """The reference's spec tree (prefix/body/remainder) as the port's
    (``layers`` one entry a layer)."""
    wrapped = jax.tree.map(_Stacked, tree, is_leaf=lambda x: isinstance(x, P))
    out = {k: wrapped[k] for k in ("embed", "final_norm")}
    out["layers"] = convert.unstack_layers(wrapped, cfg)
    return _plain(out)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    cfg, rcfg = get_config(arch), ref_config(arch)
    m = stand_in(mesh)
    want = _ref_per_layer(RSH.param_specs(RT.param_shapes(rcfg), m, rcfg), cfg)
    got = SH.param_specs(T.param_shapes(cfg), m, cfg)
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_reference(arch, mesh):
    cfg, rcfg = get_config(arch), ref_config(arch)
    m = stand_in(mesh)
    seen = 0
    for shape, spec in SHAPES.items():
        ok, _ = applicable(cfg, shape)
        assert ok == ref_applicable(rcfg, shape)[0]
        if not ok:
            continue
        rb = RSH.batch_specs(rcfg, m, ref_inputs(rcfg, shape))
        pb = SH.batch_specs(cfg, m, input_specs(cfg, shape))
        assert pb == {k: tuple(v) for k, v in rb.items()}, shape
        if spec.kind == "train":
            continue
        ref_caches = jax.eval_shape(
            lambda: RT.caches_init(rcfg, spec.batch, spec.seq, jnp.dtype(rcfg.dtype)))
        want = _ref_per_layer(
            dict(RSH.cache_specs(rcfg, m, ref_caches), embed={}, final_norm={}), cfg)["layers"]
        got = SH.cache_specs(cfg, m, T.caches_init(cfg, spec.batch, spec.seq, cfg.dtype,
                                                   device="meta"))
        assert got == want, shape
        seen += 1
    assert seen >= 1


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 2))
    assert SH.to_placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    assert SH.to_placements((), mesh) == [Replicate()] * 3
    # an axis of one rank holds the whole tensor
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1))
    assert SH.to_placements(("data", "model"), one) == [Shard(0), Replicate()]


def test_maybe_falls_back_to_replication():
    m = stand_in("16x16")
    assert SH.leaf_spec("wq", (960, 960), m) == ("data", "model")
    assert SH.leaf_spec("wq", (1000, 960), m) == (None, "model")
    assert SH.leaf_spec("w_gate", (8, 4096, 14336), m) == (None, "data", "model")
    assert SH.leaf_spec("w_gate", (64, 2048, 1408), m) == ("model", "data", None)
    assert SH.leaf_spec("scale", (1024,), m) == (None,)
