"""Training on the port (``repro_torch.train``) against the JAX package's
(``repro.train``), on the CPU, from seeded inputs, through
``repro_torch.models.convert``; then the reference's ``tests/test_train.py``
cases on the port alone.

Tolerances, each stated before its comparison:

* ``schedule``: the learning rate within 1 ulp (float32 ``cos`` of XLA and
  of ATen may differ by one).
* ``opt_update``: ``m``, ``v`` and the new masters within 2e-6 of each
  leaf's max |reference|, the grad norm within 1e-6 of it, the learning
  rate equal.  The grad norm sums the leaves in another order (the
  reference flattens its stacked tree by sorted keys) and XLA reduces
  each leaf in another order: about 2e-7 of it, which the clip scale
  carries into every leaf (largest seen 8.1e-7, in ``v``).
* gradients of ``lm_loss``: each leaf within 5e-5 of its max |jax.grad|
  (largest seen 5.7e-6, mamba2's ``A_log``; elsewhere below 1e-6).  A leaf
  that ``jax.grad`` gives as zeros is zeros (the port's unused parameters).
* train steps: ``tests/torch_train_tol.py`` (shared with the card's
  checks, where the reasons and the largest errors seen stand): the loss
  within 1e-5, the grad norm within 1e-6 of it, the masters within 0.25 x
  the step's learning rate, ``m`` within 5e-4 of each leaf's max.
* compressed train steps: the int8 codec rounds ``corrected / scale`` half
  to even, so a gradient one rounding away from a boundary moves by one
  quantum (a block's absmax / 127) in one package only, and error
  feedback carries it on.  The compressed gradients agree within 1e-6 of
  each leaf's max in all but 1e-4 of the elements at the first step and
  1 % over three (seen: 2 of 180,928, then 492, two blocks whose absmax
  moved), none by more than 1.5 quanta of the leaf's max; the masters
  within 5e-2 x the learning rate (seen 2.0e-2), the loss within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.configs import ARCHS
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.distrib import compress as JC
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as D
from repro_torch.distrib import compress as TC
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import make_train_step
from test_torch_models import _batch, _pair
from torch_train_tol import step_errors

torch.set_num_threads(1)

OPT = dict(lr=1e-3, warmup=5, total_steps=200)


def _flat(ref_tree, cfg):
    """A tree in the reference's layout (numpy, or tensors) as the port's
    ``{parameter name: tensor}``."""
    tree = jax.tree.map(np.asarray, ref_tree)
    return {k: p.detach() for k, p in convert.from_reference(tree, cfg, "cpu").named_parameters()}


def _leaf_close(got, want, rel, what):
    for k, w in want.items():
        err = float((got[k].detach() - w).abs().max())
        assert err <= rel * float(w.abs().max()), f"{what} {k}: max |err| {err}"


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("cfg", [JO.OptConfig(), JO.OptConfig(**OPT),
                                 JO.OptConfig(lr=1e-2, warmup=0, total_steps=7)])
def test_schedule_matches_the_reference(cfg):
    tcfg = TO.OptConfig(**dataclasses.asdict(cfg))
    for step in [0, 1, 2, 4, 5, 6, 50, 99, 100, 101, 199, 200, 5000, 9999, 10_000, 20_000]:
        want = np.float32(JO.schedule(cfg, step))
        got = np.float32(TO.schedule(tcfg, torch.tensor(step, dtype=torch.int32)))
        assert got.dtype == np.float32
        assert abs(got - want) <= np.spacing(want), (step, got, want)


# (state's step, gradient scale, config): a fresh state, clipped at step 2,
# and past the warmup in the cosine's decay
OPT_CASES = {"fresh-unclipped": (0, 1e-3, JO.OptConfig(**OPT)),
             "step1-clipped": (1, 1.0, JO.OptConfig(**OPT)),
             "past-warmup": (9, 1e-3, JO.OptConfig(lr=1e-3, warmup=5, total_steps=20))}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_opt_update_matches_the_reference(case):
    """On deepseek_v2_lite's smoke config (layer 0 a prefix, layers 1-2
    the stacked body): identical params, grads and state."""
    step0, gscale, cfg = OPT_CASES[case]
    jc, tc, jp, tp = _pair("deepseek_v2_lite_16b")
    rng = np.random.default_rng(5)
    g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * gscale).astype(np.float32), jp)
    m = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3 * (step0 > 0))
                     .astype(np.float32), jp)
    v = jax.tree.map(lambda x: (rng.random(x.shape) * 1e-6 * (step0 > 0)).astype(np.float32), jp)
    state = {"m": m, "v": v, "step": np.int32(step0)}
    new_p, new_s, met = JO.opt_update(cfg, jax.tree.map(jnp.asarray, jp),
                                      jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, state))

    tstate = convert.opt_state_from_reference(state, tc, "cpu")
    decay = TO.weight_decay_names(tc, tp)
    out, ts, tm = TO.opt_update(TO.OptConfig(**dataclasses.asdict(cfg)), tp, _flat(g, tc),
                                tstate, decay)
    assert out is tp and ts["m"] is tstate["m"] and int(ts["step"]) == step0 + 1
    assert ts["step"].dtype == torch.int32
    gn = float(met["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gn) <= 1e-6 * gn
    assert (gn > cfg.clip) == (case == "step1-clipped")
    assert float(tm["lr"]) == float(met["lr"])
    _leaf_close(dict(out.named_parameters()), _flat(new_p, tc), 2e-6, "params")
    _leaf_close(ts["m"], _flat(new_s["m"], tc), 2e-6, "m")
    _leaf_close(ts["v"], _flat(new_s["v"], tc), 2e-6, "v")


def test_weight_decay_follows_the_stacked_layout():
    """The reference decays a leaf of rank 2 or more in its stacked
    layout: deepseek's smoke layout is (prefix 1, period 1, reps 2), so
    layer 0's norm scale is not decayed and layer 1's is; gemma3 at full
    width, (0, 6, 10, 2), keeps its two remainder layers' norms undecayed."""
    cfg = get_smoke_config("deepseek_v2_lite_16b")
    assert TT.detect_layout(cfg) == (1, 1, 2, 0)
    p = TT.model_init(cfg, device="cpu")
    decay = TO.weight_decay_names(cfg, p)
    assert "layers.0.norm1.scale" not in decay and "final_norm.scale" not in decay
    assert {"layers.1.norm1.scale", "layers.2.norm2.scale", "layers.0.mixer.wq",
            "embed.tok"} <= decay
    gem = dataclasses.replace(get_smoke_config("gemma3_27b"), n_layers=62)
    assert TT.detect_layout(gem) == (0, 6, 10, 2)
    names = TO.weight_decay_names(gem, TT.param_shapes(gem))
    assert "layers.59.norm1.scale" in names
    assert "layers.60.norm1.scale" not in names and "layers.61.norm2.scale" not in names
    assert "layers.61.mixer.wq" in names
    # the reference's own rule on its stacked tree gives the same set
    ref = JT.model_init(jax.random.key(0), j_get_smoke_config("deepseek_v2_lite_16b"))
    marks = _flat(jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2, np.float32), ref), cfg)
    assert decay == {k for k, x in marks.items() if bool(x.flatten()[0])}


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    jc, tc, jp, tp = _pair(arch)
    b, _ = _batch(jc, 2, 32)
    g = jax.jit(jax.grad(lambda p, bb: JT.lm_loss(p, jc, bb)[0]))(jp, jax.tree.map(jnp.asarray, b))
    want = _flat(g, tc)
    loss, _ = TT.lm_loss(tp, tc, {k: torch.from_numpy(v) for k, v in b.items()})
    names, leaves = zip(*tp.named_parameters())
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for k, p, gk in zip(names, leaves, got):
        w = want[k]
        if gk is None:
            assert float(w.abs().max()) == 0, f"{k}: jax.grad reaches it, the port does not"
            continue
        err = float((gk - w).abs().max())
        assert err <= 5e-5 * float(w.abs().max()), f"{arch} {k}: max |err| {err}"


class _Remat:
    """Stands in for ``torch.utils.checkpoint.checkpoint``: counts the
    calls and, when off, calls the function straight."""

    def __init__(self, on: bool):
        self.on, self.calls = on, 0

    def __call__(self, fn, *args, **kw):
        self.calls += 1
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw) if self.on else fn(*args)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_gradients_bit_identical(arch, monkeypatch):
    """The checkpointed superblocks (``reps >= 2``) and loss chunks give
    the gradients without recomputation bit for bit; serving and
    ``torch.no_grad`` do not checkpoint."""
    cfg = get_smoke_config(arch)
    p = TT.model_init(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    b, _ = _batch(cfg, 2, 32, seed=2)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    prefix, period, reps, rem = TT.detect_layout(cfg)
    grads, calls = [], []
    for on in (True, False):
        remat = _Remat(on)
        monkeypatch.setattr(TT, "checkpoint", remat)
        loss, _ = TT.lm_loss(p, cfg, batch, loss_chunk=16)
        grads.append(torch.autograd.grad(loss, list(p.parameters()), allow_unused=True))
        calls.append(remat.calls)
    assert calls == [(reps if reps >= 2 else 0) + 2] * 2
    for a, b_ in zip(*grads):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    remat = _Remat(True)
    monkeypatch.setattr(TT, "checkpoint", remat)
    with torch.no_grad():
        TT.lm_loss(p, cfg, batch)
    if cfg.causal:
        served = {k: v[:, :4] for k, v in batch.items() if k != "labels"}
        TT.forward(p, cfg, served, caches=TT.caches_init(cfg, 2, 4, torch.float32, "cpu"))
    assert remat.calls == 0


# ------------------------------------------------------------ train steps

@pytest.mark.parametrize("arch", ["qwen3_0p6b", "deepseek_v2_lite_16b", "gemma3_27b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_the_reference(arch, accum):
    """Three steps of ``make_train_step`` from the same weights on the
    same batches, each compared: one step, then three."""
    jc, tc, jp, tp = _pair(arch)
    batches = [_batch(jc, 4, 32, seed=s)[0] for s in range(3)]
    jstep = jax.jit(j_make_train_step(jc, JO.OptConfig(**OPT), accum=accum))
    tstep = make_train_step(tc, TO.OptConfig(**OPT), accum=accum)
    jparams, jopt = jax.tree.map(jnp.asarray, jp), JO.opt_init(jp)
    topt = TO.opt_init(tp)
    for s in range(3):
        jparams, jopt, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batches[s]))
        tp, topt, tm = tstep(tp, topt, batches[s])
        assert set(tm) == set(jm) and int(topt["step"]) == s + 1
        step_errors(dict(tp.named_parameters()), topt["m"], tm,
                    _flat(jparams, tc), _flat(jopt["m"], tc), jm)


def _nest(flat):
    root = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    root["layers"] = [root["layers"][str(i)] for i in range(len(root["layers"]))]
    return root


def _stacked(flat, cfg):
    """The port's ``{name: tensor}`` in the reference's stacked layout."""
    tree = _nest(flat)
    prefix, period, reps, _ = TT.detect_layout(cfg)
    layers = tree["layers"]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*[x[k] for x in xs]) for k in xs[0]}
        return torch.stack(xs)

    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "prefix": layers[:prefix],
            "body": [stack(*[layers[prefix + r * period + j] for r in range(reps)])
                     for j in range(period)],
            "remainder": layers[prefix + reps * period:]}


def test_compressed_train_step_matches_the_reference():
    """The error-feedback codec in both packages as the ``compress`` hook.
    The codec's blocks run over a leaf's flattened elements, so in the
    reference they group the layers of a stacked leaf: the port's hook
    stacks its per-layer gradients into that layout around its codec."""
    jc, tc, jp, tp = _pair("qwen3_0p6b")
    batches = [_batch(jc, 4, 32, seed=s)[0] for s in range(3)]
    codec, zero_err = JC.make_error_feedback_codec()
    jstate = {"err": zero_err(jp)}

    def jhook(grads):
        out, jstate["err"] = codec(grads, jstate["err"])
        jstate["out"] = out
        return out

    tcodec, tzero_err = TC.make_error_feedback_codec()
    tstate = {"err": None}

    def thook(grads):
        stacked = _stacked(grads, tc)
        if tstate["err"] is None:
            tstate["err"] = tzero_err(stacked)
        out, tstate["err"] = tcodec(stacked, tstate["err"])
        tstate["out"] = _flat(out, tc)
        assert list(tstate["out"]) == list(grads)
        return tstate["out"]

    jstep = j_make_train_step(jc, JO.OptConfig(**OPT), compress=jhook)  # stateful hook: eager
    tstep = make_train_step(tc, TO.OptConfig(**OPT), compress=thook)
    jparams, jopt = jax.tree.map(jnp.asarray, jp), JO.opt_init(jp)
    topt = TO.opt_init(tp)
    differ = total = 0
    for s in range(3):
        jparams, jopt, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batches[s]))
        tp, topt, tm = tstep(tp, topt, batches[s])
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        want = _flat(jstate["out"], tc)
        for k, w in want.items():
            d = (tstate["out"][k] - w).abs()
            scale = float(w.abs().max())
            differ += int((d > 1e-6 * scale).sum())
            total += w.numel()
            assert float(d.max()) <= 1.5 * scale / 127, f"step {s} {k}: {float(d.max())}"
        assert differ <= (1e-4 if s == 0 else 1e-2) * total, (s, differ, total)
        lr = float(jm["lr"])
        want_p = _flat(jparams, tc)
        for k, p in tp.named_parameters():
            err = float((p.detach() - want_p[k]).abs().max())
            assert err <= 5e-2 * lr, f"step {s} {k}: max |err| {err} (lr {lr})"


# ------------------------------------------------------------ tests/test_train.py on the port

def _setup(arch="smollm_360m", seed=0):
    cfg = get_smoke_config(arch)
    params = TT.model_init(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, params, TO.OptConfig(**OPT)


def _data(cfg, nsteps=1):
    dc = D.DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_shard=4, seed=3)
    return [D.make_batch(dc, s, 0, device="cpu") for s in range(nsteps)]


def test_loss_decreases_overfit():
    cfg, params, opt_cfg = _setup()
    step = make_train_step(cfg, opt_cfg)
    batch = _data(cfg)[0]
    opt = TO.opt_init(params)
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::6]
    assert np.isfinite(losses).all()


def test_grad_accum_matches_full_batch():
    cfg, params, opt_cfg = _setup()
    batch = _data(cfg)[0]
    p1 = params
    p2 = TT.model_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p1, _, m1 = make_train_step(cfg, opt_cfg, accum=1)(p1, TO.opt_init(p1), batch)
    p2, _, m2 = make_train_step(cfg, opt_cfg, accum=2)(p2, TO.opt_init(p2), batch)
    assert set(m1) == {"ce", "aux", "loss", "grad_norm", "lr"}
    assert set(m2) == {"loss", "grad_norm", "lr"}
    with torch.no_grad():
        d = max(float((a - b).abs().max()) for a, b in zip(p1.parameters(), p2.parameters()))
    assert d < 2e-5, d  # identical up to reduction-order float noise


def test_compression_error_feedback_convergence():
    """int8+EF training tracks the uncompressed run closely."""
    cfg, params, opt_cfg = _setup()
    batch = _data(cfg)[0]
    codec, zero_err = TC.make_error_feedback_codec()
    state = {"err": zero_err(dict(params.named_parameters()))}

    p1 = TT.model_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    plain = make_train_step(cfg, opt_cfg)
    o1 = TO.opt_init(p1)
    losses_plain = []
    for _ in range(15):
        p1, o1, m = plain(p1, o1, batch)
        losses_plain.append(float(m["loss"]))

    def hook(grads):
        g2, state["err"] = codec(grads, state["err"])
        return g2

    comp = make_train_step(cfg, opt_cfg, compress=hook)
    p2, o2 = params, TO.opt_init(params)
    losses_c = []
    for _ in range(15):
        p2, o2, m = comp(p2, o2, batch)
        losses_c.append(float(m["loss"]))
    assert losses_c[-1] < losses_plain[0]          # it is learning
    assert abs(losses_c[-1] - losses_plain[-1]) < 0.35 * losses_plain[0]
    assert any(float(e.abs().max()) > 0 for e in state["err"].values())
