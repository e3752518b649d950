#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit's ``nvcc``; it imports nothing of JAX
or of the JAX package.  Phases, each printed with its seconds:

0. the card's name and power limit; build the kernels from the
   checkout's ``csrc`` sources (one ``nvcc`` per source, in parallel).
1. every kernel against its plain PyTorch version on the card, exactly.
2. golden parity: the digests and statistics that the JAX package
   computed on the CPU (``src/repro_torch/golden/er.json``) recomputed
   on the card.
3. the main path at full width, with the launch counters reset just
   before and read just after: ``generate(GNM(n=2^24, m=2^28), P=1)``,
   streamed ``GNP(n=2^24, p=16/2^24, directed)`` at P=16, and
   ``collect(GNP(n=2^22, p=16/2^22), P=1)``, each checked on the device.
4. each kernel timed at its main-path shape beside its plain version,
   the library call computing the same function (where there is one)
   and its bound; then the ``kernels`` line and the result line.

It exits non-zero on any failure, when no CUDA device is present and
when the script stands outside a checkout of the repository.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and int32 ALU issue = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Threefry-2x32: 20 rounds of (add, rotate, xor) plus 6 key injections of
# two adds; chunk_draw runs three per drawn slot (the 64-bit modulo is not
# counted, so the bound is a lower bound)
THREEFRY_OPS = 20 * 3 + 6 * 2


def require(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sha256_edges(edges) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(edges.cpu().numpy(), "<i8").tobytes()).hexdigest()


def sync_time(fn, reps: int = 3):
    """(result of the last call, mean ms per call) timed with CUDA events
    after one warm-up call."""
    import torch
    out = fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


class Errors:
    """Largest |kernel - plain| seen per kernel."""

    def __init__(self):
        self.max = {"chunk_draw": 0, "chunk_decode": 0, "hist": 0}

    def same(self, name: str, a, b, what: str) -> None:
        import torch
        require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype differ")
        if a.dtype == torch.bool:
            err = int((a != b).sum())
        else:
            err = int((a - b).abs().max()) if a.numel() else 0
        self.max[name] = max(self.max[name], err)
        require(err == 0, f"{what}: kernel differs from its plain version (max |err| {err})")


def phase_kernels(dev, errs: Errors) -> None:
    """Phase 1: each kernel against its plain version at test shapes."""
    import torch
    from repro_torch.kernels.hist import ops as H
    from repro_torch.kernels.hist.ref import hist_counts_ref
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import chunk_decode_ref, chunk_draw_ref

    g = torch.Generator(device=dev).manual_seed(0)
    R, cap = 64, 65536
    key = torch.randint(-2 ** 31, 2 ** 31, (R, 2), dtype=torch.int32, device=dev, generator=g)
    uni = torch.randint(0, 2 ** 50, (R,), device=dev, generator=g)
    cnt = torch.randint(0, cap + 1, (R,), device=dev, generator=g)
    uni[:4] = torch.tensor([0, 1, 3 * cap // 2, 2 * cap], device=dev)   # empty, tiny, dense rows
    cnt[:4] = torch.tensor([0, 1, cap, cap // 2], device=dev)
    cnt = torch.minimum(cnt, uni)
    for t in (0, 1, 63):
        errs.same("chunk_draw", S.chunk_draw(key, uni, cnt, t, cap),
                  chunk_draw_ref(key, uni, cnt, t, cap), f"chunk_draw t={t}")
    s = torch.sort(chunk_draw_ref(key, uni, cnt, 0, cap), dim=-1).values
    active = torch.rand(R, device=dev, generator=g) < 0.8
    errs.same("chunk_draw", S.chunk_draw(key, uni, cnt, 1, cap, s, active),
              chunk_draw_ref(key, uni, cnt, 1, cap, s, active), "chunk_draw redraw")

    kind = torch.arange(R, device=dev, dtype=torch.int32) % 4            # EMPTY, DIRECTED, TRI, RECT
    params = torch.randint(0, 2 ** 24, (R, 3), device=dev, generator=g)
    vals = torch.randint(0, 2 ** 40, (R, cap), device=dev, generator=g)
    near = torch.arange(-512, 512, device=dev)
    vals[:, :1024] = 2 ** 52 + near
    vals[:, 1024:2048] = 2 ** 62 - 1 - (near + 512)
    vals[:, 2048:3072] = near + 512
    vals = torch.sort(vals, dim=-1).values
    owned = torch.rand(R, device=dev, generator=g) < 0.7
    ea, ka = S.chunk_decode(vals, kind, params, cnt, owned)
    eb, kb = chunk_decode_ref(vals, kind, params, cnt, owned)
    errs.same("chunk_decode", ea, eb, "chunk_decode edges")
    errs.same("chunk_decode", ka, kb, "chunk_decode keep")

    v = torch.randint(-8, 1 << 23, (1 << 20,), device=dev, generator=g)
    for bins, log2, drop in ((4096, False, False), (4096, False, True), (1000, False, True),
                             (1 << 22, False, True), (1 << 22, False, False),
                             (H.LOG2_BINS, True, False)):
        errs.same("hist", H.hist_counts(v, bins, log2=log2, drop=drop),
                  hist_counts_ref(v, bins, log2=log2, drop=drop),
                  f"hist bins={bins} log2={log2} drop={drop}")


def phase_golden(dev) -> None:
    """Phase 2: recompute every golden entry of the JAX package."""
    from repro_torch import api

    doc = json.loads((ROOT / "src" / "repro_torch" / "golden" / "er.json").read_text())
    for e in doc["generate"]:
        spec = getattr(api, e["family"])(**e["params"])
        edges = api.generate(spec, e["P"], device=dev).edges
        require(len(edges) == e["m"] and sha256_edges(edges) == e["sha256"],
                f"golden generate {e['family']} {e['params']} P={e['P']}")
    for e in doc["collect"]:
        rep = api.collect(getattr(api, e["family"])(**e["params"]), e["P"], device=dev)
        d = rep.degree
        got = {"num_edges": rep.num_edges, "log2_hist": d.log2_hist.tolist(),
               "deg_sum": d.deg_sum, "deg_sumsq": d.deg_sumsq, "deg_max": d.deg_max,
               "num_isolated": d.num_isolated, "degrees_sha256": sha256_edges(d.degrees),
               "degree_counts": rep.degree_counts().tolist()}
        for k, want in got.items():
            require(want == e[k], f"golden collect {e['params']} field {k}")
    print(f"  golden: {len(doc['generate'])} edge digests, {len(doc['collect'])} collect reports equal")


def no_duplicates(key) -> bool:
    import torch
    s = torch.sort(key).values
    return not bool((s[1:] == s[:-1]).any())


# device kernel name -> group in the time breakdown; torch.sort's radix
# sort has a histogram kernel of its own, so "sort" is matched first
KERNEL_GROUPS = (("sort", "sort"), ("chunk_draw_kernel", "chunk_draw"),
                 ("chunk_decode_kernel", "chunk_decode"), ("hist_shared_kernel", "hist"),
                 ("hist_global_kernel", "hist"))


def profiled(fn):
    """(result, device ms by kernel group, wall s) of ``fn`` under
    torch.profiler; an empty dict when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or not us:
            continue
        name = ev.key.lower()
        grp = next((g for pat, g in KERNEL_GROUPS if pat in name), "other")
        groups[grp] = groups.get(grp, 0.0) + us / 1e3
    return out, groups, wall


def print_breakdown(what: str, groups: dict, wall: float) -> None:
    """Device ms by kernel group and the device's idle share of ``wall``."""
    if not groups:
        print(f"  {what} device ms by kernel: not measured (the profiler saw no device time)")
        return
    busy = sum(groups.values())
    print(f"  {what} device ms by kernel: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items()))
          + f"; device busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"(idle share {1 - busy / (wall * 1e3):.3f})")


def phase_main(dev, sizes: dict) -> dict:
    """Phase 3: the main path at full width; returns what phase 4 needs."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import build
    from repro_torch.kernels.hist.ops import LOG2_BINS, log2_histogram
    from repro_torch.kernels.hist.ref import hist_counts_ref

    n, m = sizes["gnm_n"], sizes["gnm_m"]
    spec = api.GNM(n=n, m=m, seed=1)
    t0 = time.perf_counter()
    plan = spec.plan(1)
    plan_s = time.perf_counter() - t0
    before = build.LAUNCHES["chunk_draw"]
    g, groups, wall = profiled(lambda: api.generate(spec, 1, device=dev))
    rounds = build.LAUNCHES["chunk_draw"] - before
    e = g.edges
    require(g.m == m, f"generate holds {g.m} edges, want {m}")
    require(bool((e[:, 0] > e[:, 1]).all()), "generate: an edge without u > v")
    require(no_duplicates(e[:, 0] * n + e[:, 1]), "generate: duplicate edges")
    print(f"  generate GNM(n={n}, m={m}) P=1: {plan.chunks_per_pe} chunks, capacity "
          f"{plan.capacity}, {rounds} sampler rounds, wall {wall:.3f}s (host plan "
          f"{plan_s:.3f}s), {m / wall:.4g} edges/s")
    print_breakdown("generate", groups, wall)
    del g, e
    torch.cuda.empty_cache()

    sn = sizes["stream_n"]
    sspec = api.GNP(n=sn, p=16 / sn, directed=True, seed=2)
    splan = sspec.plan(16)

    def stream():
        total = chunks = 0
        for ch in api.iter_edge_chunks(sspec, 16, device=dev):
            ce = ch.edges()
            require(len(ce) == ch.count, f"stream chunk of PE {ch.pe}: {len(ce)} edges, "
                    f"want {ch.count}")
            require(not bool((ce[:, 0] == ce[:, 1]).any()), f"stream chunk of PE {ch.pe}: a self loop")
            require(no_duplicates(ce[:, 0] * sn + ce[:, 1]), f"stream chunk of PE {ch.pe}: duplicates")
            total += len(ce)
            chunks += 1
        return total, chunks

    (total, chunks), groups, swall = profiled(stream)
    require(total == splan.total_edges, f"stream: {total} edges, plan says {splan.total_edges}")
    print(f"  stream GNP(n={sn}, directed) P=16: {chunks} chunks, capacity {splan.capacity}, "
          f"{total} edges, {swall:.3f}s, {total / swall:.4g} edges/s (checks included)")
    print_breakdown("stream", groups, swall)

    cn = sizes["collect_n"]
    cspec = api.GNP(n=cn, p=16 / cn, seed=3)
    rep, groups, cwall = profiled(lambda: api.collect(cspec, 1, device=dev))
    d = rep.degree
    require(int(d.log2_hist.sum()) == cn, "collect: log2 histogram does not sum to n")
    require(d.deg_sum == 2 * rep.num_edges, "collect: degree sum is not twice the edges")
    require(torch.equal(log2_histogram(d.degrees), hist_counts_ref(d.degrees, LOG2_BINS, log2=True)),
            "collect: hist kernel differs from its plain version on the degrees")
    print(f"  collect GNP(n={cn}) P=1: {rep.num_edges} edges, mean degree "
          f"{rep.mean_degree:.4f}, max {d.deg_max}, {cwall:.3f}s")
    print_breakdown("collect", groups, cwall)
    return {"plan": plan, "collect_spec": cspec}


def phase_timing(dev, main: dict, errs: Errors, launches: dict) -> list:
    """Phase 4: each kernel at its main-path shape."""
    import torch
    from repro_torch import api
    from repro_torch.core.sampling import sample_rows
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.hist.ops import bincount_ids
    from repro_torch.kernels.hist.ref import hist_counts_ref
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import chunk_decode_ref, chunk_draw_ref

    plan = main["plan"]
    kind, key, uni, cnt, params, _, owned = (
        t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev))
    cap = plan.capacity
    slots = kind.numel() * cap
    rows = []

    out, ms = sync_time(lambda: S.chunk_draw(key, uni, cnt, 0, cap))
    ref, plain_ms = sync_time(lambda: chunk_draw_ref(key, uni, cnt, 0, cap), reps=1)
    errs.same("chunk_draw", out, ref, "chunk_draw at full width")
    del out, ref
    drawn = int(cnt.sum())
    rows.append(("chunk_draw", "src/repro_torch/kernels/sampler/csrc/sampler.cu",
                 "src/repro/core/sampling.py:110", ms, plain_ms,
                 slots * 8 / HBM_BYTES_PER_S, drawn * 3 * THREEFRY_OPS / INT32_OPS_PER_S, None))

    vals = sample_rows(key, uni, cnt, cap)
    _, sort_ms = sync_time(lambda: torch.sort(vals, dim=-1))
    (ea, ka), ms = sync_time(lambda: S.chunk_decode(vals, kind, params, cnt, owned))
    (eb, kb), plain_ms = sync_time(lambda: chunk_decode_ref(vals, kind, params, cnt, owned), reps=1)
    errs.same("chunk_decode", ea, eb, "chunk_decode at full width")
    errs.same("chunk_decode", ka, kb, "chunk_decode keep at full width")
    del ea, ka, eb, kb, vals
    rows.append(("chunk_decode", "src/repro_torch/kernels/sampler/csrc/sampler.cu",
                 "src/repro/core/sampling.py:155", ms, plain_ms,
                 slots * (8 + 16 + 1) / HBM_BYTES_PER_S, 0.0, None))
    torch.cuda.empty_cache()
    print(f"  torch.sort [{kind.numel()}, {cap}] int64 along rows: {sort_ms:.3f} ms")

    # collect adds each chunk's endpoint ids into its section's degree
    # array in place (the first chunk's ids are that launch's shape);
    # index_add_ is the one library call computing the same function
    cspec = main["collect_spec"]
    ids = next(api.iter_edge_chunks(cspec, 1, device=dev)).edges().reshape(-1)
    bins = cspec.n
    acc = torch.zeros(bins, dtype=torch.int64, device=dev)
    ones = torch.ones_like(ids)
    _, ms = sync_time(lambda: bincount_ids(ids, bins, out=acc), reps=10)
    _, plain_ms = sync_time(lambda: acc.add_(hist_counts_ref(ids, bins, drop=True)), reps=10)
    _, lib_ms = sync_time(lambda: acc.index_add_(0, ids, ones), reps=10)
    _, bincount_ms = sync_time(lambda: torch.bincount(ids, minlength=bins), reps=10)
    errs.same("hist", bincount_ids(ids, bins), hist_counts_ref(ids, bins, drop=True),
              "hist at its main-path shape")
    touched = int(torch.unique(ids).numel())
    # each id read once, each touched bin's count read and written once
    rows.append(("hist", "src/repro_torch/kernels/hist/csrc/hist.cu",
                 "src/repro/kernels/hist/hist.py:54", ms, plain_ms,
                 (ids.numel() * 8 + touched * 16) / HBM_BYTES_PER_S, 0.0, lib_ms))
    print(f"  hist shape: {ids.numel()} ids into {bins} bins ({touched} touched); "
          f"kernel {ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
          f"torch.bincount (new array) {bincount_ms:.4f} ms")

    kernels = []
    for name, src, replaces, ms, plain_ms, bytes_s, ops_s, lib_ms in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs.max[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": lib_ms})
    return kernels


FULL = {"gnm_n": 1 << 24, "gnm_m": 1 << 28, "stream_n": 1 << 24, "collect_n": 1 << 22}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card check needs one", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    print(card_line())
    logs = build.build()
    for name, log in logs.items():
        print(f"  nvcc {name}:\n" + "\n".join("    " + ln for ln in log.strip().splitlines()
                                              if "Used" in ln or "entry" in ln))
    print(f"phase 0 build {time.perf_counter() - t0:.3f}s "
          f"({len(logs)} of {len(build.SOURCES)} libraries compiled)", flush=True)

    errs = Errors()
    t0 = time.perf_counter()
    phase_kernels(dev, errs)
    print(f"phase 1 kernels == plain {time.perf_counter() - t0:.3f}s", flush=True)

    t0 = time.perf_counter()
    phase_golden(dev)
    print(f"phase 2 golden parity {time.perf_counter() - t0:.3f}s", flush=True)

    t0 = time.perf_counter()
    build.reset_launches()
    main_out = phase_main(dev, FULL)
    launches = dict(build.LAUNCHES)
    print(f"phase 3 main path {time.perf_counter() - t0:.3f}s, launches {launches}", flush=True)
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    t0 = time.perf_counter()
    kernels = phase_timing(dev, main_out, errs, launches)
    print(f"phase 4 timing {time.perf_counter() - t0:.3f}s", flush=True)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
