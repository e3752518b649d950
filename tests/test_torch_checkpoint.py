"""Checkpoints and the training driver of the port (``repro_torch.train.checkpoint``,
``repro_torch.launch.train``) on the CPU: the reference's on-disk layout,
the reference's ``tests/test_train.py`` checkpoint cases (round trip and
elastic resume, gc and ``latest_step``, async save), a mid-training state
of the JAX package carried across (``convert.opt_state_from_reference``),
and ``python -m repro_torch.launch.train`` resumed from its own checkpoint.
Every comparison is exact: the CPU's train step is deterministic.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JCK
from repro.train import optimizer as JO
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as D
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import make_train_step
from test_torch_models import _batch, _pair
from torch_train_tol import step_errors

torch.set_num_threads(1)

OPT = dict(lr=1e-3, warmup=5, total_steps=200)


def _setup(arch="smollm_360m", seed=0):
    cfg = get_smoke_config(arch)
    params = TT.model_init(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, params, TO.OptConfig(**OPT)


def _data(cfg, nsteps=1):
    dc = D.DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_shard=4, seed=3)
    return [D.make_batch(dc, s, 0, device="cpu") for s in range(nsteps)]


def _leaves(tree):
    return {k: v.detach().clone() for k, v in CK.named_leaves(tree)}


def _equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_leaf_names_are_paths():
    cfg, params, _ = _setup("deepseek_v2_lite_16b")
    names = [k for k, _ in CK.named_leaves({"params": params, "opt": TO.opt_init(params)})]
    n = len(list(params.parameters()))
    assert len(names) == 3 * n + 1
    assert names[:n] == ["params." + k for k, _ in params.named_parameters()]
    assert "params.layers.0.norm1.scale" in names and "opt.m.layers.2.ffn.router" in names
    assert names[-1] == "opt.step"
    with pytest.raises(TypeError, match="not a tensor"):
        list(CK.named_leaves({"a": [torch.zeros(1), 3]}))


@pytest.mark.parametrize("num_shards", [1, 3])
def test_layout_matches_the_reference(tmp_path, num_shards):
    """The same tree (keys in sorted order, as JAX flattens dicts) saved by
    both packages: the same directories after ``keep`` collects, the same
    files, and shard by shard the same ``leaf_<i>`` arrays."""
    rng = np.random.default_rng(1)
    tree = {"a": [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.integers(0, 9, (5,)).astype(np.int32)],
            "b": {"c": rng.standard_normal((2,)).astype(np.float32),
                  "d": np.array(7, np.int32)},
            "e": rng.standard_normal((4, 4, 2)).astype(np.float32)}
    ttree = jax.tree.map(torch.from_numpy, tree)
    for s in (1, 2, 3, 4):
        JCK.save(str(tmp_path / "ref"), s, jax.tree.map(jnp.asarray, tree), keep=2,
                 num_shards=num_shards)
        CK.save(str(tmp_path / "port"), s, ttree, keep=2, num_shards=num_shards)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref")) == \
        ["step_00000003", "step_00000004"]
    assert CK.latest_step(str(tmp_path / "port")) == JCK.latest_step(str(tmp_path / "ref")) == 4
    for d in ("step_00000003", "step_00000004"):
        files = sorted(os.listdir(tmp_path / "ref" / d))
        assert sorted(os.listdir(tmp_path / "port" / d)) == files
        for p in range(num_shards):
            with np.load(tmp_path / "ref" / d / f"shard_{p}.npz") as want, \
                    np.load(tmp_path / "port" / d / f"shard_{p}.npz") as got:
                assert got.files == want.files
                for k in want.files:
                    np.testing.assert_array_equal(got[k], want[k])
                    assert got[k].dtype == want[k].dtype
    manifest = CK.restore(str(tmp_path / "port"), ttree)[1]
    assert manifest["names"] == ["a.0", "a.1", "b.c", "b.d", "e"]
    assert (manifest["step"], manifest["num_shards"]) == (4, num_shards)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg, params, opt_cfg = _setup()
    step = make_train_step(cfg, opt_cfg)
    opt = TO.opt_init(params)
    data = _data(cfg, 6)
    for s in range(3):
        params, opt, _ = step(params, opt, data[s])
    saved = _leaves({"params": params, "opt": opt})
    CK.save(str(tmp_path), 3, {"params": params, "opt": opt}, meta={"arch": cfg.name},
            num_shards=4)
    assert len(os.listdir(tmp_path / "step_00000003")) == 5
    # continue 3 more steps -> reference
    for s in range(3, 6):
        params, opt, _ = step(params, opt, data[s])
    # crash + restore into a fresh model and state (another seed)
    _, p2, _ = _setup(seed=7)
    o2 = TO.opt_init(p2)
    like = {"params": p2, "opt": o2}
    restored, manifest = CK.restore(str(tmp_path), like)
    assert restored is like
    assert manifest["step"] == 3 and manifest["meta"]["arch"] == cfg.name
    _equal(_leaves(like), saved)
    for s in range(3, 6):
        p2, o2, _ = step(p2, o2, data[s])
    _equal(_leaves({"params": p2, "opt": o2}), _leaves({"params": params, "opt": opt}))


def test_restore_is_elastic_in_shards(tmp_path):
    """The same state saved at 1 and at 4 shards restores the same."""
    cfg, params, _ = _setup("qwen3_0p6b")
    state = {"params": params, "opt": TO.opt_init(params)}
    for shards in (1, 4):
        CK.save(str(tmp_path / str(shards)), 2, state, num_shards=shards)
    got = []
    for shards in (1, 4):
        _, fresh, _ = _setup("qwen3_0p6b", seed=5)
        like = {"params": fresh, "opt": TO.opt_init(fresh)}
        CK.restore(str(tmp_path / str(shards)), like)
        got.append(_leaves(like))
    _equal(got[0], got[1])
    _equal(got[0], _leaves(state))


def test_restore_refuses_another_tree(tmp_path):
    cfg, params, _ = _setup("qwen3_0p6b")
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), {"params": params})
    CK.save(str(tmp_path), 1, {"params": params})
    with pytest.raises(ValueError, match="differ in leaves"):
        CK.restore(str(tmp_path), {"params": params, "extra": torch.zeros(1)})
    other = TT.model_init(cfg.replace(d_ff=2 * cfg.d_ff), device="cpu")
    with pytest.raises(ValueError, match="checkpoint shape"):
        CK.restore(str(tmp_path), {"params": other})


def test_checkpoint_gc_and_latest(tmp_path):
    cfg, params, _ = _setup()
    for s in [1, 2, 3, 4]:
        CK.save(str(tmp_path), s, {"p": params}, keep=2)
    assert CK.latest_step(str(tmp_path)) == 4
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_00000003", "step_00000004"]
    os.makedirs(tmp_path / "step_00000009.tmp")      # a save cut before its rename
    assert CK.latest_step(str(tmp_path)) == 4
    assert CK.latest_step(str(tmp_path / "none")) is None


def test_async_checkpoint(tmp_path):
    """The background save writes the state as it was when ``save``
    returned, although the masters are then changed in place."""
    cfg, params, _ = _setup()
    saved = _leaves({"p": params})
    t = CK.save(str(tmp_path), 7, {"p": params}, background=True)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
    t.join(60)
    assert not t.is_alive()
    _, fresh, _ = _setup(seed=3)
    restored, man = CK.restore(str(tmp_path), {"p": fresh})
    assert man["step"] == 7
    _equal(_leaves(restored), saved)


def test_resume_from_a_reference_state():
    """Two steps of the reference, its params and optimizer state carried
    across, then one more step in each package, held by the train steps'
    tolerances (``tests/torch_train_tol.py``)."""
    jc, tc, jp, _ = _pair("deepseek_v2_lite_16b")
    batches = [_batch(jc, 4, 32, seed=s)[0] for s in range(3)]
    jstep = jax.jit(j_make_train_step(jc, JO.OptConfig(**OPT)))
    params, opt = jax.tree.map(jnp.asarray, jp), JO.opt_init(jp)
    for s in range(2):
        params, opt, _ = jstep(params, opt, jax.tree.map(jnp.asarray, batches[s]))
    ref_params, ref_opt = jax.tree.map(np.asarray, (params, opt))
    tp = convert.from_reference(ref_params, tc, "cpu")
    topt = convert.opt_state_from_reference(ref_opt, tc, "cpu")
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == 2
    assert list(topt["m"]) == [k for k, _ in tp.named_parameters()]
    params, opt, jm = jstep(params, opt, jax.tree.map(jnp.asarray, batches[2]))
    tp, topt, tm = make_train_step(tc, TO.OptConfig(**OPT))(tp, topt, batches[2])
    flat = lambda t: {k: p.detach() for k, p in
                      convert.from_reference(jax.tree.map(np.asarray, t), tc,
                                             "cpu").named_parameters()}
    step_errors(dict(tp.named_parameters()), topt["m"], tm, flat(params), flat(opt["m"]), jm)


# ------------------------------------------------------------ launch/train.py

def _final_state(ckpt_dir, arch="qwen3_0p6b"):
    cfg = get_smoke_config(arch)
    params = TT.model_init(cfg, generator=torch.Generator().manual_seed(9), device="cpu")
    like = {"params": params, "opt": TO.opt_init(params)}
    _, manifest = CK.restore(ckpt_dir, like)
    return _leaves(like), manifest


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    """``main`` at ``--smoke`` on the CPU: 4 steps saving every 2, then
    resumed to 6, equals 6 steps in one run bit for bit."""
    common = ["--device", "cpu", "--smoke", "--arch", "qwen3_0p6b", "--ckpt-every", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert launch_train.main(common + ["--steps", "4", "--ckpt-dir", a]) == 0
    assert sorted(os.listdir(a)) == ["step_00000002", "step_00000004"]
    assert launch_train.main(common + ["--steps", "6", "--ckpt-dir", a]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.count("done") == 2
    assert "step 0 loss " in out and " it/s)" in out
    assert launch_train.main(common + ["--steps", "6", "--ckpt-dir", b]) == 0
    (resumed, m1), (straight, m2) = _final_state(a), _final_state(b)
    assert m1["step"] == m2["step"] == 6 and m1["meta"] == {"arch": get_smoke_config("qwen3_0p6b").name}
    assert int(resumed["opt.step"]) == 6
    _equal(resumed, straight)


def test_launch_train_refuses_meshes_and_needs_the_cpu_asked_for(tmp_path, capsys):
    # a model mesh needs torchrun's processes; one host only
    for flag, why in ((["--model-mesh", "2"], "needs torchrun"), (["--multihost"], "one host")):
        with pytest.raises(SystemExit) as e:
            launch_train.main(flag + ["--ckpt-dir", str(tmp_path)])
        assert e.value.code == 2
        assert why in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "step_00000001")


def test_launch_train_accumulates_and_shards_the_data(tmp_path, monkeypatch):
    """``--accum 2`` reaches ``make_train_step``, ``--data-mesh 2`` makes
    batches of two shards (eight sequences of 256)."""
    seen = {}
    real = launch_train.make_train_step

    def spy(cfg, opt_cfg, **kw):
        seen.update(kw)
        step = real(cfg, opt_cfg, **kw)

        def wrapped(params, opt, batch):
            seen["shape"] = batch["tokens"].shape
            return step(params, opt, batch)
        return wrapped

    monkeypatch.setattr(launch_train, "make_train_step", spy)
    assert launch_train.main(["--device", "cpu", "--smoke", "--arch", "qwen3_0p6b", "--steps",
                              "1", "--accum", "2", "--data-mesh", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    assert seen == {"accum": 2, "shape": (8, 256)}
    assert CK.latest_step(str(tmp_path)) == 1


def test_reference_driver_fails_at_its_embedding_gather(tmp_path, monkeypatch):
    """A fault of the reference, kept out of the parity targets (ROADMAP
    §3): ``python -m repro.launch.train`` places the masters on its
    ("data", "model") mesh, whose axes this JAX makes explicit, and the
    token lookup ``p["embed"]["tok"][tokens]`` then refuses to trace for
    want of an output sharding, before the first step.  The port's driver
    takes the same data config to the end (the tests above)."""
    import sys
    from repro.launch import train as j_launch_train

    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--arch", "qwen3_0p6b", "--steps", "1",
                                      "--ckpt-dir", str(tmp_path)])
    with pytest.raises(Exception, match="out_sharding") as e:
        j_launch_train.main()
    assert type(e.value).__name__ == "ShardingTypeError"
    assert not os.listdir(tmp_path)
