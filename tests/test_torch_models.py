"""The LM stack of the port (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, for all ten architectures.

Configs are compared field by field and parameter shapes through meta
tensors at full width.  The numerics run at each architecture's smoke
config on the reference's own weights, carried across by
``repro_torch.models.convert``: ``forward`` logits, ``lm_loss`` and
teacher-forced ``decode_step`` logits, all float32 on the CPU.

Tolerance, stated before any comparison: |port - reference| <= 1e-5 x
max |reference| for logits, 1e-5 for the loss.  Both packages compute
the same operations in float32, but XLA and ATen sum the matmuls and
einsums in different orders and use different ``exp``/``cos``/``rsqrt``
implementations: a few ulp an operation, which grows to about 1e-6 of
the logits' range over the layers (the largest seen is 3.6e-7
relative).  A wrong mask, rotation, cache slot or dropped expert choice
moves logits by 1e-3 or more.  MoE routing is compared exactly (expert
choices, keep masks, destinations) on a batch that overflows capacity.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

REL = 1e-5      # logits: of the reference's max |logit|
LOSS_ABS = 1e-5


def _pair(arch, key=0, **replace):
    """(reference cfg, port cfg, reference params, port params) on the
    same weights."""
    jc = jbase.get_smoke_config(arch).replace(**replace)
    tc = tbase.get_smoke_config(arch).replace(**replace)
    jp = JT.model_init(jax.random.key(key), jc)
    return jc, tc, jp, convert.from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"positions": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend != "none":
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        b["tokens"] = toks
    return b, toks


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), f"{what}: max |err| {err}"


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.d_inner, t.n_ssm_heads) == (j.hd, j.d_inner, j.n_ssm_heads)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]
    for shape in jbase.SHAPES:
        assert tbase.applicable(t, shape) == jbase.applicable(j, shape)
    full = tbase.get_config(arch)
    assert full.compute_dtype == torch.bfloat16 and full.master_dtype == torch.float32
    assert t.compute_dtype == torch.float32


def test_registry_and_input_specs():
    assert tbase.ARCHS == jbase.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        j, t = jbase.get_config(arch), tbase.get_config(arch)
        for shape in jbase.SHAPES:
            js, ts = jbase.input_specs(j, shape), tbase.input_specs(t, shape)
            assert set(ts) == set(js)
            for k in js:
                assert ts[k].device.type == "meta"
                assert tuple(ts[k].shape) == js[k].shape
                assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype)


class _Shape:
    """A reference ShapeDtypeStruct that unstacks like an array."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), str(dtype)

    def __getitem__(self, r):
        return _Shape(self.shape[1:], self.dtype)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch):
    """Full width, meta tensors on both sides: every layer's leaves, in
    the port's per-layer layout, have the reference's shapes and dtypes."""
    j, t = jbase.get_config(arch), tbase.get_config(arch)
    ref = jax.tree.map(lambda s: _Shape(s.shape, s.dtype), JT.param_shapes(j))
    want = {"embed": ref["embed"], "final_norm": ref["final_norm"],
            "layers": convert.unstack_layers(ref, j)}
    got = TT.param_shapes(t)
    w = {k: (v.shape, v.dtype) for k, v in _flat(want)}
    g = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _flat(got)}
    assert g == w
    assert all(p.device.type == "meta" for p in got.parameters())
    n = sum(p.numel() for p in got.parameters())
    assert abs(n - t.param_count()) <= 0.01 * n


@pytest.mark.parametrize("arch", ARCHS)
def test_detect_layout_matches_the_reference(arch):
    for cfg in (jbase.get_config(arch), jbase.get_smoke_config(arch)):
        tcfg = tbase.get_config(arch).replace(**{f.name: getattr(cfg, f.name)
                                                 for f in dataclasses.fields(cfg)})
        assert TT.detect_layout(tcfg) == JT.detect_layout(cfg)
        assert [TT.layer_signature(tcfg, i) for i in range(cfg.n_layers)] == \
            [JT.layer_signature(cfg, i) for i in range(cfg.n_layers)]


def test_param_counts_are_plausible():
    expect = {"smollm_360m": (0.3e9, 0.5e9), "qwen3_0p6b": (0.5e9, 0.85e9),
              "hubert_xlarge": (0.9e9, 1.3e9), "mamba2_2p7b": (2.4e9, 3.1e9)}
    for arch, (lo, hi) in expect.items():
        assert lo < tbase.get_config(arch).param_count() < hi


def test_layer_patterns():
    gem = tbase.get_config("gemma3_27b")
    assert [gem.layer_attn_kind(i) for i in range(12)] == ["swa"] * 5 + ["full"] + ["swa"] * 5 \
        + ["full"]
    jam = tbase.get_config("jamba_v0_1_52b")
    assert [jam.layer_kind(i) for i in range(8)] == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert sum(jam.layer_kind(i) == "attn" for i in range(32)) == 4


def test_model_init_scales_and_generator():
    cfg = tbase.get_smoke_config("jamba_v0_1_52b")
    a, b = (TT.model_init(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu").requires_grad_(False) for _ in range(2))
    for (ka, va), (kb, vb) in zip(_flat(a), _flat(b)):
        assert ka == kb and torch.equal(va, vb)
    assert float(a["embed"]["tok"].std()) == pytest.approx(1.0, rel=0.05)
    assert float(a["embed"]["head"].std()) == pytest.approx(0.02, rel=0.05)
    wo = a["layers"][4]["mixer"]["wo"]
    assert float(wo.std()) == pytest.approx(0.02 / math.sqrt(2 * cfg.n_layers), rel=0.1)
    mix = a["layers"][0]["mixer"]
    assert torch.equal(mix["A_log"], torch.zeros_like(mix["A_log"]))
    assert torch.equal(mix["D"], torch.ones_like(mix["D"]))
    assert float(mix["conv_w"].std()) == pytest.approx(0.2, rel=0.1)
    assert a["layers"][1]["ffn"]["router"].dtype == torch.float32
    assert all(p.requires_grad for p in TT.model_init(cfg, device="cpu").parameters())


def test_entry_points_default_to_cuda():
    """``model_init``, ``caches_init`` and ``from_reference`` run on CUDA
    unless the caller asks for the CPU: without a card they raise
    rather than build the model on the CPU; ``"meta"`` gives shapes."""
    cfg = tbase.get_smoke_config("qwen3_0p6b")
    calls = (lambda: TT.model_init(cfg), lambda: TT.caches_init(cfg, 1, 4, torch.float32),
             lambda: convert.from_reference({"embed": {}, "final_norm": {}, "prefix": [],
                                             "body": [], "remainder": []},
                                            cfg.replace(n_layers=0)))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert TT.model_init(cfg, device="meta")["embed"]["tok"].device.type == "meta"
    assert TT.caches_init(cfg, 1, 4, torch.float32, "cpu")[0]["k"].device.type == "cpu"


# ------------------------------------------------------------ numerics

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference(arch):
    jc, tc, jp, tp = _pair(arch)
    b, _ = _batch(jc, 2, 32)

    @jax.jit
    def ref(p, batch):
        h, aux, _ = JT.forward(p, jc, batch)
        loss, m = JT.lm_loss(p, jc, batch)
        return h @ p["embed"]["head"].astype(h.dtype), aux, loss, m["ce"]

    logits, aux, loss, ce = ref(jp, jax.tree.map(jnp.asarray, b))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    h, taux, _ = TT.forward(tp, tc, tb)
    tlogits = h @ tp["embed"]["head"].to(h.dtype)
    tloss, tm = TT.lm_loss(tp, tc, tb)
    _close(tlogits.detach().numpy(), logits, f"{arch} forward logits")
    assert abs(float(tloss) - float(loss)) <= LOSS_ABS
    assert abs(float(tm["ce"]) - float(ce)) <= LOSS_ABS
    assert abs(float(taux) - float(aux)) <= LOSS_ABS
    assert np.isfinite(float(tloss)) and 0 < float(tloss) < 3 * np.log(tc.vocab)
    # differentiable: a finite gradient reaches every master the loss
    # uses (not the token table of a frontend model, nor norm2 where a
    # layer has no FFN)
    tloss.backward()
    unused = {k for k, p in tp.named_parameters() if p.grad is None}
    assert all(torch.isfinite(p.grad).all() for p in tp.parameters() if p.grad is not None)
    assert unused == ({"embed.tok"} if tc.frontend != "none" else set()) | (
        {f"layers.{i}.norm2.scale" for i in range(tc.n_layers)} if not (tc.d_ff or tc.moe)
        else set())


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert_xlarge"])
def test_decode_matches_the_reference_and_the_full_forward(arch):
    jc, tc, jp, tp = _pair(arch, key=1)
    B, S = 2, 16
    b, toks = _batch(jc, B, S, seed=1)
    step = jax.jit(lambda p, t, q, c: JT.decode_step(p, jc, t, q, c))
    caches = JT.caches_init(jc, B, S, jnp.float32)
    tcaches = TT.caches_init(tc, B, S, torch.float32, "cpu")
    pos = b["positions"]
    ref, got = [], []
    with torch.no_grad():
        for t in range(S):
            lg, caches = step(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
                              caches)
            tl, tcaches = TT.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                         torch.from_numpy(pos[:, t:t + 1]), tcaches)
            ref.append(np.asarray(lg))
            got.append(tl.numpy())
        assert [c["idx"] for c in tcaches] == [S] * tc.n_layers
        _close(np.concatenate(got, 1), np.concatenate(ref, 1), f"{arch} decode logits")
        # and against the port's own full forward (the reference test's
        # tolerance: MoE capacity differs between batch sizes)
        fb = {"positions": torch.from_numpy(pos)}
        if tc.frontend != "none":
            fb["embeds"] = tp["embed"]["tok"][torch.from_numpy(toks).long()]
        else:
            fb["tokens"] = torch.from_numpy(toks)
        h, _, _ = TT.forward(tp, tc, fb)
        full = (h @ tp["embed"]["head"]).numpy()
    dec = np.concatenate(got, 1)
    rel = float(np.abs(dec - full).max()) / float(np.abs(full).max())
    assert rel < (5e-3 if tc.moe else 1e-4), rel


@pytest.mark.parametrize("window,S", [(8, 24), (8, 8), (16, 20)])
def test_ring_decode_matches_the_reference(window, S):
    """tests/test_ring_cache.py's ring cases on both packages: teacher-
    forced decode through several window wraps."""
    jc, tc, jp, tp = _pair("mixtral_8x7b", key=2, window=window, n_experts=4)
    B = 2
    toks = np.array(jax.random.randint(jax.random.key(2), (B, S), 0, jc.vocab,
                                       dtype=jnp.int32))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    step = jax.jit(lambda p, t, q, c: JT.decode_step(p, jc, t, q, c))
    caches = JT.caches_init(jc, B, S, jnp.float32)
    tcaches = TT.caches_init(tc, B, S, torch.float32, "cpu")
    assert tcaches[0]["k"].shape[1] == min(S, window)
    ref, got = [], []
    with torch.no_grad():
        for t in range(S):
            lg, caches = step(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
                              caches)
            tl, tcaches = TT.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                         torch.from_numpy(pos[:, t:t + 1]), tcaches)
            ref.append(np.asarray(lg))
            got.append(tl.numpy())
        for layer in range(tc.n_layers):
            np.testing.assert_allclose(tcaches[layer]["k"].numpy(),
                                       np.asarray(caches["body"][0]["k"][layer]),
                                       rtol=0, atol=REL * 10)
    _close(np.concatenate(got, 1), np.concatenate(ref, 1), "ring decode logits")


def test_ring_prefill_then_decode_matches_the_reference():
    """Prefill S0 > window tokens (the rolled write), then decode."""
    jc, tc, jp, tp = _pair("mixtral_8x7b", key=3, window=8, n_experts=4)
    B, S0, S1 = 2, 16, 6
    S = S0 + S1
    toks = np.array(jax.random.randint(jax.random.key(3), (B, S), 0, jc.vocab,
                                       dtype=jnp.int32))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    caches = JT.caches_init(jc, B, S, jnp.float32)
    _, _, caches = JT.forward(jp, jc, {"tokens": jnp.asarray(toks[:, :S0]),
                                       "positions": jnp.asarray(pos[:, :S0])}, caches=caches)
    tcaches = TT.caches_init(tc, B, S, torch.float32, "cpu")
    with torch.no_grad():
        _, _, tcaches = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks[:, :S0]),
                                            "positions": torch.from_numpy(pos[:, :S0])},
                                   caches=tcaches)
        # the rolled ring: slot == position % window
        for layer in range(tc.n_layers):
            np.testing.assert_allclose(tcaches[layer]["k"].numpy(),
                                       np.asarray(caches["body"][0]["k"][layer]),
                                       rtol=0, atol=REL * 10)
        step = jax.jit(lambda p, t, q, c: JT.decode_step(p, jc, t, q, c))
        ref, got = [], []
        for t in range(S0, S):
            lg, caches = step(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
                              caches)
            tl, tcaches = TT.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                         torch.from_numpy(pos[:, t:t + 1]), tcaches)
            ref.append(np.asarray(lg))
            got.append(tl.numpy())
    _close(np.concatenate(got, 1), np.concatenate(ref, 1), "ring prefill + decode logits")


# ------------------------------------------------------------ MoE routing

class _Spy:
    """Stands in for the reference layers' ``jax`` module: records what
    ``lax.top_k`` returns and what the dispatch's vmapped group
    functions receive."""

    def __init__(self, rec):
        self.rec = rec
        spy = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                out = jax.lax.top_k(x, k)
                spy.rec["top_k"] = out
                return out

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, f):
        def call(*args):
            self.rec[f.__name__] = args
            return jax.vmap(f)(*args)
        return call


@pytest.mark.parametrize("arch,cf,dtype", [("mixtral_8x7b", 0.5, "float32"),
                                           ("deepseek_v2_lite_16b", 0.4, "float32"),
                                           ("jamba_v0_1_52b", 1.25, "float32"),
                                           ("mixtral_8x7b", 0.5, "bfloat16")])
def test_moe_routing_matches_the_reference_exactly(arch, cf, dtype, monkeypatch):
    """On a batch that overflows capacity: expert choices, gates, keep
    masks and destination rows equal the reference's exactly, and the
    layer's output within the stated tolerance.  In bfloat16 the router
    is a bfloat16-rounded master that both multiply in float32, so the
    gates keep the float32 tolerance; the output takes bfloat16's."""
    jc, tc, jp, tp = _pair(arch, key=4, capacity_factor=cf, dtype=dtype)
    i = next(i for i in range(jc.n_layers) if jc.layer_is_moe(i))
    layer = convert.unstack_layers(jax.tree.map(np.asarray, jp), jc)[i]
    x = (np.random.default_rng(4).standard_normal((3, 40, jc.d_model))).astype(np.float32)
    rec = {}
    monkeypatch.setattr(JL, "jax", _Spy(rec))
    want, aux = JL.moe(JT.cast_params(jax.tree.map(jnp.asarray, layer["ffn"]), jc.dtype), jc,
                       jnp.asarray(x).astype(jc.dtype))
    monkeypatch.undo()
    tffn = TT.cast_params(tp["layers"][i]["ffn"], tc.dtype)
    tx = torch.from_numpy(x).to(tc.compute_dtype)
    xg = tx.reshape(1, -1, tc.d_model)
    with torch.no_grad():
        gate, expert, keep, dest, C, taux = TL.moe_route(tffn, tc, xg)
    y_ref, dest_ref, keep_ref, gate_ref = rec["gather_group"]
    np.testing.assert_array_equal(expert.numpy(), np.asarray(rec["top_k"][1]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_ref))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_ref))
    np.testing.assert_allclose(gate.numpy(), np.asarray(gate_ref), rtol=REL, atol=0)
    assert C == y_ref.shape[2]
    if cf < 1:
        assert not keep.all(), "the batch must overflow capacity"
    with torch.no_grad():
        got, taux2 = TL.moe(tffn, tc, tx)
    assert got.dtype == tc.compute_dtype
    if dtype == "float32":
        _close(got.numpy(), want, f"{arch} moe output")
    else:   # one layer's bfloat16 outputs: an ulp apart in places, so the max bound alone
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert float(err.max()) <= BF16_MAX * float(np.abs(np.asarray(want, np.float32)).max())
    assert abs(float(taux2) - float(aux)) <= LOSS_ABS and float(taux) == float(taux2)


def test_top_k_breaks_ties_by_the_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [1.0, 1.0, 1.0, 1.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = TL.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4], [0, 1, 2]]


# ------------------------------------------------------------ mixed precision

def test_cast_params_matches_the_reference():
    """Every float32 leaf of two or more dimensions (the MoE router too)
    goes to the compute dtype; 1-D leaves stay float32."""
    j = jbase.get_smoke_config("jamba_v0_1_52b").replace(dtype="bfloat16")
    t = tbase.get_smoke_config("jamba_v0_1_52b").replace(dtype="bfloat16")
    jp = JT.model_init(jax.random.key(0), j)
    # the reference casts one layer's slice at a time (inside its scan)
    ref = [jax.tree.map(lambda a: _Shape(a.shape, a.dtype), JT.cast_params(layer, j.dtype))
           for layer in convert.unstack_layers(jp, j)]
    tp = convert.from_reference(jax.tree.map(np.asarray, jp), t, device="cpu")
    got = TT.cast_params(tp["layers"], t.dtype)
    w = {k: v.dtype for k, v in _flat(ref)}
    g = {k: str(v.dtype).split(".")[-1] for k, v in _flat(got)}
    assert g == w
    moe = next(L for L in got if "router" in L.get("ffn", {}))
    assert moe["ffn"]["router"].dtype == torch.bfloat16
    assert got[0]["mixer"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("S", [16, 128])
def test_mamba2_rounds_dt_only_on_the_padded_branch(S, monkeypatch):
    """bf16 compute: with S % chunk != 0 the reference rounds dt to the
    model dtype before ``_ssd_chunked``, and at S == chunk it does not;
    the port passes the same dt both ways, and the same output within
    bf16's tolerance."""
    j = jbase.get_smoke_config("mamba2_2p7b").replace(dtype="bfloat16")
    t = tbase.get_smoke_config("mamba2_2p7b").replace(dtype="bfloat16")
    jp = JT.model_init(jax.random.key(5), j)
    layer = convert.unstack_layers(jax.tree.map(np.asarray, jp), j)[0]["mixer"]
    x = (np.random.default_rng(5).standard_normal((2, S, j.d_model)) * 0.5).astype(np.float32)
    seen = {}
    real_j, real_t = JL._ssd_chunked, TL._ssd_chunked
    monkeypatch.setattr(JL, "_ssd_chunked", lambda *a: (seen.setdefault("j", a[1]),
                                                        real_j(*a))[1])
    monkeypatch.setattr(TL, "_ssd_chunked", lambda *a: (seen.setdefault("t", a[1]),
                                                        real_t(*a))[1])
    pj = JT.cast_params(jax.tree.map(jnp.asarray, layer), j.dtype)
    want, _ = JL.mamba2(pj, j, jnp.asarray(x, jnp.bfloat16))
    pt = TT.cast_params({k: torch.from_numpy(np.array(v)) for k, v in layer.items()}, t.dtype)
    got, _ = TL.mamba2(pt, t, torch.from_numpy(x).to(torch.bfloat16))
    dj, dt = np.asarray(seen["j"]), seen["t"]
    assert dt.dtype == torch.float32 and str(dj.dtype) == "float32"
    rounded = torch.equal(dt, dt.to(torch.bfloat16).to(torch.float32))
    assert rounded == (S % 128 != 0)
    assert bool(np.array_equal(dj, np.asarray(jnp.asarray(dj).astype(jnp.bfloat16)
                                              .astype(jnp.float32)))) == rounded
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-6)
    err = float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())
    assert err <= 0.05 * float(np.abs(np.asarray(want, np.float32)).max())


# bfloat16 compute against the reference's bfloat16, both on the same
# float32 masters.  Tolerance, stated before any comparison: max |port -
# reference| <= 2^-6 x max |reference| (four bfloat16 ulps at the top of
# the logits' range: bfloat16 keeps 8 significant bits, and the two
# packages round each operation's output after sums taken in different
# orders, which leaves the logits one or two ulps apart), and the mean
# |port - reference| <= BF16_MEAN[arch] x mean |reference|.  Attention and
# MoE stacks agree bit for bit in about 95 % of their logits (mean 1e-4):
# a missing float32 up-cast in a norm puts the mean near 3e-3, so 1e-3.
# mamba2's chunked scan sums in float32 in a different order, so its
# bfloat16 outputs disagree by an ulp in about half of the elements (mean
# 3e-3): 8e-3.
BF16_MAX = 2.0 ** -6
BF16_MEAN = {"qwen3_0p6b": 1e-3, "mixtral_8x7b": 1e-3, "deepseek_v2_lite_16b": 1e-3,
             "mamba2_2p7b": 8e-3}


def _close_bf16(got, want, arch, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert float(err.max()) <= BF16_MAX * float(np.abs(want).max()), \
        f"{arch} {what}: max |err| {float(err.max())}"
    assert float(err.mean()) <= BF16_MEAN[arch] * float(np.abs(want).mean()), \
        f"{arch} {what}: mean |err| {float(err.mean())}"


@pytest.mark.parametrize("arch", sorted(BF16_MEAN))
def test_bf16_forward_and_decode_match_the_reference(arch):
    """Prefill logits, teacher-forced decode logits and the caches'
    dtypes in bfloat16 compute (the full configs' dtype), on the same
    masters as the reference's bfloat16 run."""
    jc, tc, jp, tp = _pair(arch, key=7, dtype="bfloat16")
    B, S = 2, 16
    b, toks = _batch(jc, B, S, seed=7)

    @jax.jit
    def ref(p, batch):
        h, _, _ = JT.forward(p, jc, batch)
        return h @ p["embed"]["head"].astype(h.dtype)

    want = ref(jp, jax.tree.map(jnp.asarray, b))
    step = jax.jit(lambda p, t, q, c: JT.decode_step(p, jc, t, q, c))
    caches = JT.caches_init(jc, B, S, jnp.bfloat16)
    tcaches = TT.caches_init(tc, B, S, torch.bfloat16, "cpu")
    pos = b["positions"]
    dref, dgot = [], []
    with torch.no_grad():
        h, _, _ = TT.forward(tp, tc, {k: torch.from_numpy(v) for k, v in b.items()})
        got = h @ tp["embed"]["head"].to(h.dtype)
        for t in range(S):
            lg, caches = step(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
                              caches)
            tl, tcaches = TT.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                         torch.from_numpy(pos[:, t:t + 1]), tcaches)
            dref.append(np.asarray(lg.astype(jnp.float32)))
            dgot.append(tl.float().numpy())
    assert got.dtype == tl.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    _close_bf16(got.float().numpy(), want.astype(jnp.float32), arch, "forward logits")
    _close_bf16(np.concatenate(dgot, 1), np.concatenate(dref, 1), arch, "decode logits")
    ref_dt = {(k, str(v.dtype)) for c in jax.tree.leaves(caches, is_leaf=lambda x: (
        isinstance(x, dict) and "idx" in x)) for k, v in c.items() if k != "idx"}
    got_dt = {(k, str(v.dtype).split(".")[-1]) for c in tcaches for k, v in c.items()
              if k != "idx"}
    assert got_dt == ref_dt
