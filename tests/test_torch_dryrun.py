"""The port's dry run (``repro_torch.launch.dryrun``, ``opcost``, ``mesh``,
``sweep``) and its table (``launch/roofline.py``'s CLI) on the CPU, at
qwen3's smoke config on fake process groups (1 and 8 ranks).

* on a (1, 1) mesh the record's matmul flops equal ``FlopCounterMode``'s
  count of the same step run on real tensors, and no collective is
  issued;
* on a (4, 2) mesh the train step issues collectives, its useful-flops
  ratio is at most 1, and prefill and decode run;
* ``applicable``'s skips come through as ``status: skipped``;
* the generator cell runs one PE's program with zero collectives;
* ``make_table`` renders an ok record, a skip and an error as the
  reference's does (the peak and the fit against the H100's 80 GB apart).
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, mesh as M, roofline, sweep
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

ARCH = "qwen3_0p6b"
TRAIN = ShapeSpec("train_smoke", "train", 32, 8)


@pytest.fixture(scope="module")
def records():
    """Records of qwen3's smoke config: train on (1, 1) and (4, 2),
    prefill and decode on (4, 2); the fake group is destroyed after."""
    cfg = get_smoke_config(ARCH)
    out = {}
    try:
        M.reset()
        out["1x1"] = dryrun.run_cell(ARCH, TRAIN.name, False, mesh=M.make_debug_mesh(1, 1),
                                     cfg=cfg, spec=TRAIN)
        M.reset()
        mesh = M.make_debug_mesh(4, 2)
        for spec in (TRAIN, ShapeSpec("prefill_smoke", "prefill", 64, 8),
                     ShapeSpec("decode_smoke", "decode", 64, 8)):
            out[spec.kind] = dryrun.run_cell(ARCH, spec.name, False, mesh=mesh, cfg=cfg,
                                             spec=spec)
        out["links"] = {a: dryrun.link_bytes_per_s(mesh, a) for a in mesh.mesh_dim_names}
    finally:
        M.reset()
    return out


def test_flops_at_1x1_equal_flop_counter_on_the_real_step(records):
    cfg = get_smoke_config(ARCH)
    params = T.model_init(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (TRAIN.batch, TRAIN.seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (TRAIN.batch, TRAIN.seq)).astype(np.int32),
             "positions": np.tile(np.arange(TRAIN.seq, dtype=np.int32), (TRAIN.batch, 1))}
    step = make_train_step(cfg, O.OptConfig())
    with FlopCounterMode(display=False) as fc:
        step(params, O.opt_init(params), batch)
    rec = records["1x1"]
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["per_device"]["flops_by"]["matmul"] == fc.get_total_flops() > 0
    assert rec["per_device"]["flops"] > rec["per_device"]["flops_by"]["matmul"]
    assert rec["collectives"] == {} and rec["per_device"]["collective_bytes"] == 0
    assert rec["roofline"]["collective_s"] == 0.0


def test_peak_at_1x1_equals_the_real_steps(records):
    """The (1, 1) dry run's peak is the live storages' peak of the same
    step on real tensors (within a few 512-byte blocks: DTensor makes a
    scalar or two of its own), which holds the masters, both moments and
    the gradients (float32, 4 bytes each a parameter) at the least."""
    from repro_torch.launch.opcost import OpCost
    cfg = get_smoke_config(ARCH)
    params = T.model_init(cfg, device="cpu")
    opt = O.opt_init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (TRAIN.batch, TRAIN.seq)
                                             ).astype(np.int32)) for k in ("tokens", "labels")}
    batch["positions"] = torch.arange(TRAIN.seq, dtype=torch.int32).repeat(TRAIN.batch, 1)
    cost = OpCost()
    cost.hold((params, opt, batch))
    with cost:
        make_train_step(cfg, O.OptConfig())(params, opt, batch)
    n = sum(p.numel() for p in params.parameters())
    peak = records["1x1"]["memory"]["peak_per_device"]
    assert abs(peak - cost.peak_bytes) <= 4 * 512
    assert cost.peak_bytes >= 4 * 4 * n


def test_train_on_4x2_issues_collectives(records):
    rec = records["train"]
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["mesh"] == {"data": 4, "model": 2}
    assert rec["collectives"] and rec["per_device"]["collective_bytes"] > 0
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "broadcast"}
    assert sum(rec["collective_bytes_by_axis"].values()) == rec["per_device"]["collective_bytes"]
    assert 0 < rec["useful_flops_ratio"] <= 1
    # a rank holds its shards: less state than the whole on one device
    assert rec["memory"]["peak_per_device"] < records["1x1"]["memory"]["peak_per_device"]
    r = rec["roofline"]
    assert rec["dominant"] == max(r, key=r.get)
    assert r["collective_s"] > 0


MESHES = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _train_dry_run(mesh_name, cost_type=None, monkeypatch=None):
    """The OpCost of qwen3's smoke train step on one of ``MESHES``."""
    if cost_type is not None:
        monkeypatch.setattr(dryrun, "OpCost", cost_type)
    try:
        M.reset()
        mesh = M.make_mesh(*MESHES[mesh_name])
        return dryrun.run_step(ARCH, TRAIN, mesh, cfg=get_smoke_config(ARCH))[2]
    finally:
        M.reset()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_vocab_parallel_loss_keeps_each_ranks_logits_its_own(mesh_name, monkeypatch):
    """The chunked loss's logits, their log-sum-exp and their gradient
    stay each rank's: every [batch, chunk, vocab] tensor an op of the step
    makes (a view of a broadcast costs nothing) is of the rank's share of
    the batch and of the vocabulary, never the whole of either."""
    from repro_torch.launch.opcost import OpCost, _tensors
    vocab = get_smoke_config(ARCH).vocab
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    tp, rows = sizes["model"], TRAIN.batch // (sizes["data"] * sizes.get("pod", 1))
    made = []

    class Made(OpCost):
        def _count(self, func, args, kwargs, out):
            super()._count(func, args, kwargs, out)
            if not func.is_view:
                made.extend((func.name(), tuple(t.shape)) for t in _tensors(out)
                            if t.dim() == 3 and t.shape[-1] in (vocab, vocab // tp))

    _train_dry_run(mesh_name, Made, monkeypatch)
    assert made and {s for _, s in made} == {(rows, TRAIN.seq, vocab // tp)}, sorted(set(made))


def test_pod_axis_lowers_the_peak():
    """``pod`` is pure data parallelism: at one global batch, a (2, 2, 2)
    mesh halves each rank's batch and shards the parameters as (2, 2)
    does, so its peak a device is no higher."""
    peaks = {m: _train_dry_run(m).peak_bytes for m in MESHES}
    assert 0 < peaks["2x2x2"] <= peaks["2x2"]


def test_prefill_and_decode_on_4x2(records):
    for kind in ("prefill", "decode"):
        rec = records[kind]
        assert rec["status"] == "ok", kind
        assert rec["per_device"]["flops"] > 0 and rec["memory"]["peak_per_device"] > 0


def test_links(records):
    assert records["links"] == {"data": dryrun.NVLINK_BYTES_PER_S,
                                "model": dryrun.NVLINK_BYTES_PER_S}
    import types
    prod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert [dryrun.link_bytes_per_s(prod, a) for a in ("pod", "data", "model")] == [
        dryrun.NDR_BYTES_PER_S] * 3


@pytest.mark.parametrize("arch,shape", [("hubert_xlarge", "decode_32k"),
                                        ("qwen3_0p6b", "long_500k")])
def test_skips_come_through(arch, shape):
    rec = dryrun.run_cell(arch, shape, False)
    assert rec["status"] == "skipped" and rec["reason"]
    assert rec["shape"] == shape


def test_generator_cell_is_communication_free():
    rec = dryrun.run_generator_cell(False, n=1 << 12, m=1 << 14, chips=4, device="cpu")
    assert rec["zero_collectives"] and rec["collectives"] == {}
    assert rec["chips"] == 4 and rec["per_device"]["collective_bytes"] == 0
    assert rec["edges_pe0"] == rec["edges_pe0_plan"] > 0
    assert rec["launches"].get("chunk_sample", 0) >= 1
    assert rec["per_device"]["bytes"] > 0 and rec["roofline"]["memory_s"] > 0


def _ref_table(rows, multi_pod=False):
    import repro  # noqa: F401
    from repro.launch import roofline as R
    return R.make_table(rows, multi_pod)


def test_make_table_renders_as_the_reference(records, tmp_path):
    ok = dict(records["train"], arch=ARCH, shape="train_4k")
    skip = dryrun.run_cell("hubert_xlarge", "decode_32k", False)
    err = {"arch": "mixtral_8x7b", "shape": "prefill_32k", "multi_pod": False,
           "status": "error", "stderr": "Traceback (most recent call last): boom"}
    for d in (ok, skip, err):
        with open(tmp_path / f"{d['arch']}.{d['shape']}.json", "w") as f:
            json.dump(d, f)
    rows = roofline.load(str(tmp_path))
    assert len(rows) == 3
    got, want = roofline.make_table(rows).splitlines(), _ref_table(rows).splitlines()
    assert len(got) == len(want) == 5
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        gc, wc = g.split(" | "), w.split(" | ")
        if "skipped" in g or "ERROR" in g:
            assert g == w
        else:   # peak GB a chip and fits: 10^9 bytes and 80 GB against 2^30 and 16 GiB
            assert gc[:6] + gc[8:] == wc[:6] + wc[8:]
            peak = ok["memory"]["peak_per_device"]
            assert gc[6:8] == [f"{peak / 1e9:.1f}", "yes"]
    roofline.main(["--dir", str(tmp_path)])


def test_sweep_records_errors_and_skips(tmp_path):
    rec = sweep.run_one("hubert_xlarge", "decode_32k", False, str(tmp_path), timeout=300)
    assert rec["status"] == "skipped"
    rec = sweep.run_one("no_such_arch", "train_4k", False, str(tmp_path), timeout=300)
    assert rec["status"] == "error" and "no_such_arch" in rec["reason"]
    again = sweep.run_one("no_such_arch", "train_4k", False, str(tmp_path), timeout=300)
    assert again == json.loads((tmp_path / "no_such_arch.train_4k.sp.json").read_text())
    assert len(sweep.cells(sweep.ARCHS, sweep.SHAPES)) == 10 * 4 + 10 + 2
