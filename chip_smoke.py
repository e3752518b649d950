#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit's ``nvcc``; it imports nothing of JAX
or of the JAX package.  Phases, each printed with its seconds:

0. the card's name and power limit; build the kernels from the
   checkout's ``csrc`` sources (one ``nvcc`` per source, in parallel).
1. every kernel against its plain PyTorch version on the card, exactly
   (and ``torch.addcmul`` on the card against an exact FMA): the
   collision sampler ``chunk_sample`` on rows of every path (count 0,
   universes 0, 1 and 3, the last with buckets past shared memory, dense
   rows that take many redraw rounds or never finish), also with small
   bucket and list caps that force its paths for large buckets and many
   duplicates, its rounds per row included; the six
   device functions of ``kernels/geom/csrc/libm.cuh`` (XLA-CPU's exp,
   expm1, log1p; glibc's log, sin, cos) against their plain versions on
   10^6 inputs each; ``pair_edges`` on batches of every row kind mixed
   (capacities 1 to 256, past the staged tile) and ``cell_points`` on
   cube and polar cells with empty ones (capacities 1 to 4000), and
   ``pair_edges`` wave by wave on the stream of RHG(n=2^20, gamma=2.2) at
   P=16, whose core disk makes capacity 224.
   The Delaunay kernels (``triangulate``, ``circumspheres``) and the
   GEOM_CERT rows of ``pair_edges`` likewise, on random, degenerate and
   real RDG rows.  ``chunk_rmat`` and ``chunk_ba`` on chunk rows of every
   kind mixed, ``close_wedges`` on the union tables of neighbour tables
   with all-sentinel rows, up to 1024 samples and 40000 neighbours (unions
   past the filter's size), chunk and pair buffers, against both plain
   versions (over the neighbour table and over its union table).
2. golden parity: the digests and statistics that the JAX package
   computed on the CPU (``src/repro_torch/golden/er.json``, ``geom.json``,
   ``rdg.json``, ``families.json`` and ``stats.json``) recomputed on the
   card, RHG radii included, the card's RHG features against the
   reference's, the sampled clustering reports and six ``validate``
   reports (every float64 and line), bit for bit.
3. the main paths at full width, each with the launch counters reset
   just before and read just after:
   a. Erdős–Rényi: ``generate(GNM(n=2^24, m=2^28), P=1)`` (its sampler
      rounds read from the device, each row's count), streamed
      ``GNP(n=2^24, p=16/2^24, directed)`` at P=16, and
      ``collect(GNP(n=2^22, p=16/2^22), P=1)``;
   b. geometric: ``generate(RGG(n=2^22, r=0.55 sqrt(ln n / n)), P=1,
      return_points=True)`` with every edge's distance recomputed by the
      plain euclid tile, ``iter_points`` of that spec, streamed
      ``RHG(n=2^20, avg_deg=16, gamma=2.8)`` at P=16 against
      ``generate`` of it at P=1, and ``collect`` of it at P=16;
   c. Delaunay: ``generate(RDG(n=2^20, dim=2), P=1, return_points=True)``
      (exactly 3n edges), streamed at P=16 (the same checksum),
      ``generate(RDG(n=2^16, dim=3), P=1)``, and RDG(n=2^16, dim=2) and
      RDG(n=2^13, dim=3) against scipy's Qhull on the 3^d tiling.  (In
      3-D the reference's triangulation clears ``ok`` on rows of about
      20k points and more, a cavity past its capacity early in the
      insertion, so its halo rounds end on Qhull once the regions wrap,
      and RDG(n=2^18, dim=3) raises "halo did not converge" there as here;
      see ROADMAP §3);
   d. families: ``generate(RMAT(log_n=26, m=2^30), P=1)`` (top-bit
      shares within 0.5 % of a + b and a + c) and ``BA(n=2^25, d=8)``
      (n d edges, every target at or before its source), each against its
      stream at P=16 by an order-free checksum; ``SBM(n=2^24, 16 blocks,
      p_in=2^-17, p_out=2^-21)`` at P=1 (u > v, no duplicate, every block
      region's density within 2 % of its p) against its stream at P=16;
      ``collect`` with clustering of RHG(n=2^20) at P=16 (the same report
      at P=1) and of that SBM at P=1 (its triangles recounted from the
      generated edges), each with its wedge table's build time;
   e. validation and overlap: ``validate`` of the specs above (GNP(2^22)
      at P=1 through ``hist``'s chi-square, GNM(2^24, 2^28), RHG(2^20) at
      P=16 by the Hill fit, RDG(2^20, 2-D) at P=1, BA(2^25, 8), RMAT(26,
      2^30) and the SBM at P=16), each report printed in full with its
      collect and gate seconds, every gate required; then the SBM
      streamed at P=16 with overlap 0, 4, 4, 0 in turns and a cold
      RDG(2^18, 2-D, seed 16) with overlap 0 then 4 (time to the first
      chunk, wall, the consumer's wait on the planner; the RDG had 2^20
      points and a second pair of turns before the training path and
      path 3l's collects needed the time),
      every run with the same checksum and per-PE digests,
      the overlapped RDG runs triangulating on the planner thread; the
      planner wait is the sum of the ``plan/overlap/wait`` spans of a run
      traced by ``repro_torch.obs``;
   f. serving: ``Service(P=16, slab_batch=16)`` takes 40 requests at once
      (8 GNM(n=2^22, m=2^26), 8 GNP(2^22, 16/2^22), 8 BA(2^22, 16), 8
      SBM(2^22, 16 blocks, p_in=2^-15, p_out=2^-19), 4 RMAT(22, 2^26), 4
      RHG(n=2^15, avg_deg=16, gamma=2.8)), the first of each family into
      a graph sink, the rest into stats sinks, and 6 more after 8 ticks
      (one a family, plan-cache hits); every request against
      ``generate(spec, 16)`` (edges, or edge count and degrees), whose
      calls are the naive loop; the fleet again, traced and under the
      profiler (the device's idle share, seconds by phase and span); an
      SBM request with ``overlap=4`` into a chunks sink against
      ``iter_edge_chunks`` chunk by chunk; RDG(n=2^18) cold
      (``triangulate`` on admission) and reseeded; fault reissue on a
      GNM with D=4 slab rows; an RGG of capacity 4097..7261 served at
      class 8192 and HYP rows at class 4096 (``pair_edges`` staged by
      counts); each family's cold plan against its reseed;
   g. contract checking (``repro_torch.analyze``): the port and this
      script lint clean; every program of the registry (8 families x
      plan kinds x run and wave, the serving slabs, the ``pair_mask``
      and ``triangulate`` kernel cases) runs on the card under the op
      scan and ``set_sync_debug_mode("error")`` with no finding, its
      outputs equal to the same case's on the CPU (plain versions) bit
      for bit; a slot function planted with ``.item()``, ``nonzero`` or
      ``torch.rand`` is found once by the scan and by
      ``runtime.run(check=True)``; ``generate(GNM(n=2^24, m=2^28), 1)``
      with ``check=True`` on a cold slot-function cache against
      ``check=False``, in turns (the check's one-time cost);
   h. the LM stack's serving path (``repro_torch.data``, ``models``,
      ``train.serve``): ``make_global_batch`` at ``launch/train.py``'s
      data config (``rhg_walk``, n = 4096, sequences of 256, four a
      shard, seed 11) with 1 and 4 shards, steps 0 to 3, and one
      ``er_walk`` batch, on the card with the graphs cold (timed, each
      ``rhg_pe`` call's wall printed), then again with every
      ``hyp_edges`` launch of ``rhg_pe`` (one a graph, and no
      ``pair_mask`` launch) and every ``chunk_sample``/``chunk_decode``
      launch of ``gnm_undirected_pe`` held against its plain version on
      the same inputs, the launches of a pass printed; every batch's
      digests equal
      to ``golden/data.json`` on the card and on the CPU; the ten
      architectures at smoke size in float32, the same weights on the
      card and on the CPU (``forward`` logits, ``lm_loss``, teacher-forced
      ``decode_step`` against the forward); Qwen3-0.6B at full width
      (28 layers, d_model 1024, vocab 151,936) from a seeded generator,
      ``generate`` in bf16 for 8 of the pipeline's prompts of 256 tokens
      and 64 greedy steps (prefill and generate timed in turns; prefill
      tokens/s and its share of the bf16 peak, decode ms a step, tokens/s
      and its share of HBM bandwidth, peak memory, one decode step's aten
      census under sync-debug "error", the device's idle share under the
      profiler), then float32 teacher-forced decode against the full
      forward at full width;
   i. training (``repro_torch.train``, ``launch/train.py``): the ten
      architectures at smoke size in float32, a ``make_train_step`` step
      with ``accum=1`` then one with ``accum=2`` on the card against the
      CPU from the same weights, held by the CPU tests' tolerances
      (``tests/torch_train_tol.py``); Qwen3-0.6B at full width in bf16:
      ``launch/train.py``'s ``main`` for 20 steps at its data config (the
      graph cold, the ``hyp_edges`` launch of the first batch held
      against its plain version, no ``pair_mask`` launch), checkpointed in
      the background at step
      12 and at the end, each step timed (median, min–max after the
      first, tokens/s, the share of the bf16 dense peak, ``launch/cost.py``'s
      ``lm_train`` bound, peak memory); ``opt_update`` alone and three
      steps under the profiler (device ms by group, idle share); 30 steps
      overfitting one batch (the last loss below 0.7 x the first); the
      trained 9.0 GB state saved at 4 shards in the background while 3
      steps run on, restored in a fresh process (spawned; the state at
      the save shared with it by CUDA IPC) bit for bit, the same 3 steps
      run there twice (is the card's step deterministic?) and against
      the uninterrupted run; a float32 step with ``accum=2`` against
      ``accum=1`` within a quarter of its learning rate;
   j. meshes and dry run (``repro_torch.launch.dryrun``, ``mesh``,
      ``models.shardings``, ``pmesh``): the dry runs of Qwen3-0.6B at
      ``train_4k`` and ``decode_32k`` on the fake 16 x 16 process group
      (two host processes, while the rest runs), each record's peak,
      per-device counts and roofline at the H100's data-sheet rates;
      the dry run of path 3i's step on a (1, 1) mesh against that step
      run on the card: the predicted peak within 3 % of the step's own
      ``max_memory_allocated`` and its matmul flops equal to
      ``FlopCounterMode``'s; the prefill and decode dry runs of Qwen3's
      smoke config on a fake (4, 2) mesh (the decode attention on this
      torch's DTensor); the generator cell (``GNM(2^30, 2^34)``
      planned at 256 and 512 ranks, PE 0's program on the card under
      the op scan, no collective, its plan's edge count, each
      ``chunk_sample`` and ``chunk_decode`` launch equal to its plain
      version on the same inputs);
   k. generation across ranks (``repro_torch.distrib.world``): four
      spawned ranks, every one on this card and ``World.from_env()``
      from torchrun's variables, no process group; each generates its
      own PEs at P = 16: ``generate(GNM(2^24, 2^28))``, streamed
      ``SBM(2^24, 16 blocks)`` (its native segments), ``RHG(2^20)``
      (``pair_edges``) and ``RDG(2^16, 2-D)`` (``triangulate`` on each
      rank; 2^18 points until path 3l needed the time), and its PEs'
      ``gnm_directed_pe`` and ``rmat_pe`` at
      GNM(2^24, 2^28, directed) and RMAT(26, 2^30), all with
      ``check=True`` or under the op trace, each rank's first
      ``chunk_sample``, ``chunk_decode`` and ``pair_edges`` launch held
      against its plain version; then the small per-PE generators
      (n = 2^14) on its PEs.
      Meanwhile this process runs the small generators on the CPU, and
      then the same specs at P = 16 on the card in one process.  Every
      rank's per-PE digests must equal the one process's, the small
      generators' card digests their CPU digests, and no rank's op scan
      may find a collective; each rank's wall, the world's (the slowest
      rank's) and the one process's are printed, which with four ranks
      on one card measure correctness, not scaling.  Then a world of two
      spawned ranks that own two rows each (``World.from_env(cards=2)``:
      rows 2r and 2r+1 of four, both on this card, a stream each), each
      generating its PEs of the GNM and streaming those of the SBM, every
      row's first ``chunk_decode`` launch held;
      every per-PE digest equal to the one process's;
   l. one process over local cards (``repro_torch.distrib.world.LocalMesh``,
      the reference's default mesh ``mesh_for(P)``): four rows on this
      card, each on a stream of its own, P = 16: ``generate(GNM(2^24,
      2^28))`` (every row's first ``chunk_sample`` and ``chunk_decode``
      launch held against its plain version; the digest equal to one
      device's; both timed, with the gathering device's peak), the SBM
      stream with overlap 0 and 2 and the RHG stream in waves of 32,768
      rows (every row's first ``pair_edges`` launch held) equal chunk by
      chunk to the integer ``mesh=4`` stream on the one card, each chunk
      on the device of the row that streams it (``runtime.stream_row``:
      under overlap, its segment's row), and a ``Service`` fleet (4 GNM(2^22, 2^26),
      4 SBM(2^22, 16 blocks), the RHG) with the last row dead at slab 1,
      every ticket equal to ``generate``; ``collect`` on the four rows
      (each chunk counted into its row's partial counts, on the row's
      card; the four rows' partials summed once, on the first) against
      one device, field by field: GNP(2^22,
      16/2^22) exact, the directed GNP(2^24) stream spec binned, SBM(2^24,
      16 blocks) and RHG(2^20) (waves of 32,768 rows) with clustering,
      every row's first ``hist`` and ``close_wedges`` launch held, walls
      and the gathering device's peak; ``validate`` of the GNP and the
      SBM on the rows against one device; with two cards or more the same
      on ``mesh_for(16)``'s distinct cards, else a line saying that the
      machine has one card.  Rows on one card measure correctness, not
      scaling;
   each checked on the device; each ``collect`` must launch ``hist`` once
   per non-empty chunk of its first pass, on the card of the row that
   streamed it, plus once per section histogram.  The generator
   paths run ``pair_mask``'s tiles inside ``pair_edges``, as the
   reference's engine does; ``rhg_pe`` runs the hyp tile over all its
   segments in one ``hyp_edges`` call (paths h and i), and ``pair_mask``
   itself is launched by the registry's kernel case (path g).
4. each kernel timed at its main-path shape beside its plain version,
   the library call computing the same function (where there is one)
   and its bound (``pair_mask`` at its own contract's shape, the
   128-row cell blocks of the oracles, built from the main path's pair
   rows and held against ``pair_edges``' keep; ``triangulate`` at every
   halo round of the 2-D RDG plan (its plain version on the first row of
   a round of several rows, and on the whole of a one-row round, which
   the ``kernels`` line reports), with its cluster size and its trip
   split into parts by the kernel's clock64 counters, ``circumspheres``
   and the CERT rows of ``pair_edges`` at the inputs of its first round;
   ``hist`` also by the profiler's device time per call, beside
   ``index_add_``; ``pair_edges`` also at the RGG generate shape and on
   the CERT rows of the 2-D RDG plan, ``cell_points`` also at the RHG
   point plan, each beside its bound, the short ones also by a replayed
   CUDA graph; ``chunk_sample`` at the GNM generate shape and the
   largest SBM batch, each in turns with ``torch.sort`` of the same rows,
   with its device ms by kernel (the plain version by groups of rows);
   ``chunk_rmat`` and ``chunk_ba`` at their generate shapes, the plain
   versions on the first 2^22 slots, ``chunk_ba`` with the chain steps its
   lanes walked and its warps issued; ``close_wedges`` at the largest SBM chunk and
   RHG wave of the clustering collects, with its table's size, the probes
   and merge steps of that data, its device time by a replayed CUDA graph
   and PR 16's bound beside the new one); then the ``kernels`` line and the
   result line.  The kernel timings also print the median and min–max of
   their reps one at a time, and each ``kernels`` entry carries that
   median as ``median_ms`` beside the back-to-back mean ``ms``.  Path h
   adds the ``hyp_edges`` row at ``rhg_pe``'s table at P = 1, with its
   device time by a replayed CUDA graph of its passes and by the
   profiler; the dense route it replaced (a ``pair_mask`` launch a
   segment, the masks copied back, ``np.nonzero``) against it in turns on
   the same segments at P = 1 and P = 4, with the same hits in the same
   order; ``rhg_pe``'s walls, warm; and a second ``pair_mask`` row, the
   hyp tile at the largest segment on the dense route's padded blocks.
   Path i adds no row: its step runs cuBLAS and ATen, its ``hyp_edges``
   launch joins the kernel's count; paths j, k and l neither, their
   launches (the ranks' included) join their kernels' counts.

It exits non-zero on any failure, when no CUDA device is present and
when the script stands outside a checkout of the repository.

``--only PATH`` (``er``, ``geom``, ``rdg``, ``families``, ``stats``, ``serve``, ``analyze``,
``lm``, ``train``, ``mesh``, ``world``, ``local``; repeatable)
builds and runs
only that main path and its phase 4 timing, and ``--no-timing`` stops
after the path: run the same script in two checkouts in turns to
compare them on one card.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def cost():
    """The analytic bytes and operations of the kernels' launches
    (``repro_torch.launch.cost``): every bound below comes from it."""
    from repro_torch.launch import cost as c

    return c


def bound_terms(c) -> tuple:
    """``(bytes seconds, operations seconds)`` of a launch's cost against
    the H100 SXM's peaks (``repro_torch.launch.roofline.H100``)."""
    from repro_torch.launch.roofline import H100

    return c.seconds(H100)



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


def timed(fn, reps: int = 3, label: str = "", each: bool = True):
    """(result of the last call, mean ms per call, median ms of a call)
    timed with CUDA events after one warm-up call.  The mean is the span
    of ``reps`` back-to-back calls over their count, so it carries the
    host's gaps between calls; the median is that of ``reps`` calls each
    timed by an event pair of its own (one at a time), printed with its
    min–max when there is a label.  With one rep, or ``each`` false, the
    median is the mean."""
    import statistics
    import torch
    out = fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    mean = start.elapsed_time(stop) / reps
    if reps == 1 or not each:
        return out, mean, mean
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record()
        out = fn()
        b.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ev]
    median = statistics.median(ms)
    if label:
        print(f"  time {label}: mean {mean:.6f} ms back to back; one at a time median "
              f"{median:.6f}, min {min(ms):.6f}, max {max(ms):.6f} ({reps} reps)")
    return out, mean, median


def sync_time(fn, reps: int = 3, label: str = ""):
    """(result of the last call, mean ms per call): :func:`timed`, with the
    calls one at a time only when there is a label."""
    return timed(fn, reps, label, each=bool(label))[:2]


class Errors:
    """Largest |kernel - plain| seen per kernel."""

    def __init__(self):
        self.max = {"chunk_sample": 0, "chunk_decode": 0, "hist": 0,
                    "pair_mask": 0, "hyp_edges": 0, "pair_edges": 0, "cell_points": 0,
                    "triangulate": 0, "circumspheres": 0,
                    "chunk_rmat": 0, "chunk_ba": 0, "close_wedges": 0}

    def same(self, name: str, a, b, what: str) -> None:
        import torch
        require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype differ")
        if a.dtype == torch.bool:
            err = int((a != b).sum())
        elif a.dtype.is_floating_point:
            # NaN slots (none are expected) count as a difference
            err = float(torch.nan_to_num((a - b).abs(), nan=float("inf")).max()) if a.numel() else 0
        else:
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        self.max[name] = max(self.max[name], err)
        require(err == 0, f"{what}: kernel differs from its plain version (max |err| {err})")


def phase_kernels(dev, errs: Errors) -> None:
    """Phase 1: each kernel against its plain version at test shapes."""
    import torch
    from repro_torch.kernels.hist import ops as H
    from repro_torch.kernels.hist.ref import hist_counts_ref
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import chunk_decode_ref, sample_rows_ref
    from torch_sampler_rows import sampler_rows

    g = torch.Generator(device=dev).manual_seed(0)
    # rows of every path: the universe-3 row's buckets (about 21,845 values
    # each) outgrow shared memory; the universe-0 and universe = count rows
    # never finish (63 rounds); caps (64, 4) merge-sort every bucket past 64
    # values in global memory, (8192, 0) lists no duplicate
    for R, cap, (bcap, lcap) in ((64, 65536, (8192, 1024)), (64, 65536, (64, 4)),
                                 (64, 65536, (8192, 0)), (37, 8193, (8192, 1024))):
        key, uni, cnt = sampler_rows(R, cap, R + cap, dev)
        rounds, want_rounds = (torch.full((R,), -1, dtype=torch.int32, device=dev)
                               for _ in range(2))
        errs.same("chunk_sample",
                  S.chunk_sample(key, uni, cnt, cap, rounds, bucket_cap=bcap, list_cap=lcap),
                  sample_rows_ref(key, uni, cnt, cap, want_rounds),
                  f"chunk_sample [{R}, {cap}] caps ({bcap}, {lcap})")
        errs.same("chunk_sample", rounds, want_rounds, f"chunk_sample rounds [{R}, {cap}]")
        require(int(rounds.max()) == 63, "chunk_sample: no row ran all 63 rounds")
    print(f"  chunk_sample == plain on rows of every path, rounds per row up to "
          f"{int(rounds.max())}: {want_rounds.tolist()[:10]} (the leading rows)")
    R, cap = 64, 65536
    key, uni, cnt = sampler_rows(R, cap, R + cap, dev)

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
    # runs of equal ids (the warp adds each run once), views off the
    # 16-byte load width and of odd length
    runs = torch.repeat_interleave(v[:1 << 16], torch.randint(1, 33, (1 << 16,), device=dev,
                                                              generator=g))
    for bins in (1 << 22, 8192, 1000):
        for w in (runs, runs[1:], runs[3:-2], v[5:6]):
            errs.same("hist", H.bincount_ids(w, bins), hist_counts_ref(w, bins, drop=True),
                      f"hist runs bins={bins} n={w.numel()}")


def exact_fma(x, y, z, single: bool) -> float:
    """fma(x, y, z) rounded once, to float64 or (single) to float32."""
    import numpy as np
    from fractions import Fraction
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    if not single:
        return float(exact)
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess, np.nextafter(guess, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - exact) for c in cands]
    tied = [c for c, e in zip(cands, err) if e == min(err)]
    return float(min(tied, key=lambda c: int(np.float32(c).view(np.uint32)) & 1))


def check_addcmul(dev) -> None:
    """The plain versions spell XLA's fused multiply-adds as
    ``torch.addcmul``: on the card it must round once, like an FMA."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.float64, torch.float32):
        x, y, z = (torch.randn(2048, dtype=dtype, device=dev, generator=g) for _ in range(3))
        got = torch.addcmul(z, x, y).cpu().tolist()
        want = [exact_fma(a, b, c, dtype == torch.float32)
                for a, b, c in zip(x.cpu().tolist(), y.cpu().tolist(), z.cpu().tolist())]
        require(got == want, f"torch.addcmul on the card is not a single-rounded FMA ({dtype})")


def hyp_rows(dev, g, B: int, M: int):
    """float64 feature rows [B, M, 8] of random points (r, θ)."""
    import math
    import torch
    r = torch.rand((B, M), dtype=torch.float64, device=dev, generator=g) * 12 + 0.2
    t = torch.rand((B, M), dtype=torch.float64, device=dev, generator=g) * 2 * math.pi
    f = torch.zeros((B, M, 8), dtype=torch.float64, device=dev)
    f[..., 0], f[..., 1] = torch.cos(t), torch.sin(t)
    f[..., 2], f[..., 3] = torch.cosh(r) / torch.sinh(r), 1 / torch.sinh(r)
    return f


GEOM_CHECK = [("RGG", dict(n=1 << 16, radius=0.0072, seed=61)),
              ("RGG", dict(n=1 << 15, radius=0.03, dim=3, seed=62)),
              ("RHG", dict(n=1 << 16, avg_deg=16.0, gamma=2.8, seed=63))]


def phase_libm(dev) -> None:
    """Phase 1: each device function of libm.cuh against its plain version
    on the card and on the CPU, bit for bit, on 10^6 inputs over its RHG
    domain and its branch and table boundaries (tests/torch_libm_inputs.py;
    the CPU tests hold the plain versions to XLA's and glibc's)."""
    import numpy as np
    import torch
    from repro_torch.kernels.geom import ops as G
    from torch_libm_inputs import INPUTS

    for k, name in enumerate(sorted(INPUTS)):
        x = torch.from_numpy(INPUTS[name](np.random.default_rng(300 + k)))
        got = G.libm_eval(name, x.to(dev))
        card = G.LIBM_FUNCTIONS[name](x.to(dev))
        cpu = G.LIBM_FUNCTIONS[name](x)
        bits = got.view(torch.int64)
        require(torch.equal(bits, card.view(torch.int64)),
                f"libm {name} on the card differs from its plain version on the card")
        require(torch.equal(bits.cpu(), cpu.view(torch.int64)),
                f"libm {name} on the card differs from its plain version on the CPU")
    print(f"  libm: {', '.join(sorted(INPUTS))} equal their plain versions (card and CPU) on "
          f"{len(x)}+ inputs each")


def phase_geom_kernels(dev, errs: Errors) -> None:
    """Phase 1, geometric kernels: pair_mask with thresholds set exactly on
    accumulator values, pair_edges and cell_points on whole plans."""
    import torch
    from repro_torch import api
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.geom import ops as G
    from repro_torch.kernels.geom.ref import cell_points_ref, pair_edges_ref
    from repro_torch.kernels.pairmask import ops as M
    from repro_torch.kernels.pairmask.ref import pair_mask_ref
    from repro_torch.kernels.geom.ref import GEOM_TORUS
    from torch_geom_rows import ALL_KINDS, cell_rows, pair_rows

    check_addcmul(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for dim in (2, 3):
        a = torch.rand((4, 512, 8), device=dev, generator=g)
        b = (a[:, :384] + 0.02 * torch.randn((4, 384, 8), device=dev, generator=g)).contiguous()
        d = [a[:, :, None, k] - b[:, None, :, k] for k in range(dim)]
        acc = torch.addcmul(d[1] * d[1], d[0], d[0])
        if dim == 3:
            acc = torch.addcmul(acc, d[2], d[2])
        for r2 in (float(acc[0, 5, 7]), float(acc[3, 100, 200]), 4e-4):
            errs.same("pair_mask", M.pair_mask(a, b, r2, tile="euclid", dim=dim),
                      pair_mask_ref(a, b, r2, tile="euclid", dim=dim),
                      f"pair_mask euclid dim={dim} r2={r2}")
            # off the 128 x 128 tile and the 4-byte store width
            ra, rb = a[:, :200].contiguous(), b[:, :130].contiguous()
            errs.same("pair_mask", M.pair_mask(ra, rb, r2, tile="euclid", dim=dim),
                      pair_mask_ref(ra, rb, r2, tile="euclid", dim=dim),
                      f"pair_mask euclid dim={dim} r2={r2} [4, 200] x [4, 130]")
    q, c = hyp_rows(dev, g, 4, 512), hyp_rows(dev, g, 4, 384)
    rest = torch.addcmul(torch.addcmul(q[:, :, None, 1] * c[:, None, :, 1], q[:, :, None, 0],
                                       c[:, None, :, 0]), -q[:, :, None, 2], c[:, None, :, 2])
    p = q[:, :, None, 3] * c[:, None, :, 3]
    for cosh_r in (float(-rest[0, 5, 7] / p[0, 5, 7]), float(-rest[2, 300, 17] / p[2, 300, 17]),
                   1.2e6):
        errs.same("pair_mask", M.pair_mask(q, c, cosh_r, tile="hyp"),
                  pair_mask_ref(q, c, cosh_r, tile="hyp"), f"pair_mask hyp cosh_r={cosh_r}")

    # every kind mixed in one launch, self pairs, inactive rows, row counts
    # off a tile's rows, and rows past a staged tile (from capacity 128 with
    # HYP rows, 142 with TORUS rows alone); cube and polar cells with empty
    # ones, staged and (cap dim past 7260) drawn straight into the output
    cases = [(ALL_KINDS, cap, dim) for cap in (1, 4, 24, 128, 144, 208, 256) for dim in (2, 3)]
    cases += [((GEOM_TORUS,), cap, 2) for cap in (141, 142, 208, 256)]
    for kinds, cap, dim in cases:
        for R in (1, 777):
            rows = pair_rows(R, cap, dim, seed=cap * 100 + dim * 10 + R, device=dev, kinds=kinds)
            kw = dict(capacity=cap, dim=dim, kinds=kinds)
            what = f"kinds={kinds} cap={cap} dim={dim} R={R}"
            ea, ka = G.pair_edges(*rows, **kw)
            eb, kb = pair_edges_ref(*rows, **kw)
            errs.same("pair_edges", ea, eb, f"pair_edges edges {what}")
            errs.same("pair_edges", ka, kb, f"pair_edges keep {what}")
            del ea, ka, eb, kb
    for kind, dim in (("cube", 2), ("cube", 3), ("polar", 2)):
        for cap in (1, 25, 1024, 4000):
            rows, scale = cell_rows(1001, cap, dim, kind, seed=cap, device=dev)
            kw = dict(kind=kind, scale=scale, capacity=cap, dim=dim)
            pa, ma = G.cell_points(*rows, **kw)
            pb, mb = cell_points_ref(*rows, **kw)
            errs.same("cell_points", pa, pb, f"cell_points {kind} dim={dim} cap={cap}")
            errs.same("cell_points", ma, mb, f"cell_points mask {kind} dim={dim} cap={cap}")

    for fam, kw in GEOM_CHECK:
        spec = getattr(api, fam)(**kw)
        plan = spec.plan(4)
        rows = [t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev)]
        kw_pe = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
        ea, ka = G.pair_edges(*rows, **kw_pe)
        eb, kb = pair_edges_ref(*rows, **kw_pe)
        errs.same("pair_edges", ea, eb, f"pair_edges edges {fam} {kw}")
        errs.same("pair_edges", ka, kb, f"pair_edges keep {fam} {kw}")
        require(bool(ka.any()), f"pair_edges {fam}: no edge kept")
        del ea, ka, eb, kb
        pp = spec.point_plan(4)
        prow = [t.reshape(-1, *t.shape[2:]) for t in plan_tensors(pp, dev)]
        kw_cp = dict(kind=pp.kind, scale=pp.scale, capacity=pp.capacity, dim=pp.dim)
        pa, ma = G.cell_points(*prow, **kw_cp)
        pb, mb = cell_points_ref(*prow, **kw_cp)
        errs.same("cell_points", pa, pb, f"cell_points {fam} {kw}")
        errs.same("cell_points", ma, mb, f"cell_points mask {fam} {kw}")
        torch.cuda.empty_cache()


# the capacities at which phase 1 runs the plain version's geometry test
# on a wide-RHG row: the smallest that holds the row's points
WIDE_CAPS = (16, 32, 64, 128)
# the waves whose rows phase 1 tests in one plain call a width (the plain
# version is some thousand small launches a call, whatever its rows)
WIDE_GROUP = 32


def pair_keep_by_width(rows, *, capacity: int, dim: int, kinds):
    """The keep of ``pair_edges_ref(*rows, capacity=capacity, dim=dim,
    kinds=kinds)``, with each row's geometry test run at the smallest of
    ``WIDE_CAPS`` (or ``capacity``) that holds its points: one plain call
    a width.  A point's draw depends on its index, not on the capacity,
    and no slot past a row's points is kept, so this is the plain
    version's keep exactly: a row's first c x c slots from the plain
    version at capacity c, every other slot False.  (The plain version's
    edges are its index part, ``kinds=()``, the same on rows without
    CERT.)"""
    import torch
    from repro_torch.kernels.geom.ref import GEOM_CERT, pair_edges_ref

    require(GEOM_CERT not in kinds, "pair_keep_by_width: CERT rows keep by their certificate")
    R, N = rows[0].shape[0], capacity
    keep = torch.zeros((R, N, N), dtype=torch.bool, device=rows[0].device)
    most = torch.maximum(rows[3], rows[4]).clamp(0, N)
    caps = [c for c in WIDE_CAPS if c < N] + [N]
    width = torch.full_like(most, N)
    for c in caps[::-1]:
        width = torch.where(most <= c, c, width)
    for c in caps:
        sel = torch.nonzero(width == c).flatten()
        if sel.numel():
            _, k = pair_edges_ref(*(t[sel] for t in rows), capacity=c, dim=dim, kinds=kinds)
            keep[sel, :c, :c] = k.view(-1, c, c)
    return keep.view(R, N * N)


def phase_wide_rhg(dev, errs: Errors) -> None:
    """Phase 1, pair_edges on wide rows at full width: RHG(n=2^20,
    avg_deg=16, gamma=2.2), whose core cell holds some 230 points (one row
    a tile, keep bytes stored as they are computed), streamed by
    ``iter_edge_chunks`` at P=16 and held, wave by wave, against the plain
    version on the same rows: its edges, and its keep tested
    ``WIDE_GROUP`` waves at a time (``pair_keep_by_width``).  (Its P=1
    ``generate`` would write 1.8 TB of slots.)"""
    import torch
    from repro_torch import api
    from repro_torch.distrib.runtime import plan_tensors, wave_schedule
    from repro_torch.kernels.geom.ref import pair_edges_ref

    t0 = time.perf_counter()
    n, B = 1 << 20, 2048
    spec = api.RHG(n=n, avg_deg=16.0, gamma=2.2, seed=64)
    plan = spec.plan(16, device=dev)
    require(plan.capacity >= 208, f"RHG gamma=2.2: capacity {plan.capacity}, want >= 208")
    ws = wave_schedule(plan, 1, B)
    tables = plan_tensors(plan, dev)
    sched = torch.from_numpy(ws.sched[:, 0]).to(dev, torch.int64)
    valid = torch.from_numpy(ws.valid[:, 0]).to(dev)
    N = plan.capacity
    waves = edges = 0
    for w, ch in enumerate(api.iter_edge_chunks(spec, 16, device=dev, batch=B)):
        if w % WIDE_GROUP == 0:
            s = sched[w: w + WIDE_GROUP].reshape(-1, 2)
            keeps = pair_keep_by_width([t[s[:, 0], s[:, 1]] for t in tables], capacity=N,
                                       dim=plan.dim, kinds=plan.kinds_present).view(-1, B, N * N)
        s = sched[w]
        eb, _ = pair_edges_ref(*(t[s[:, 0], s[:, 1]] for t in tables), capacity=N,
                               dim=plan.dim, kinds=())
        errs.same("pair_edges", ch.buffer, eb, f"RHG gamma=2.2 wave {w}: edges")
        errs.same("pair_edges", ch.mask, keeps[w % WIDE_GROUP] & valid[w][:, None],
                  f"RHG gamma=2.2 wave {w}: keep")
        edges += int(ch.mask.sum())
        waves += 1
        del ch, eb
    require(waves == ws.num_waves, f"RHG gamma=2.2: {waves} waves, the plan has {ws.num_waves}")
    print(f"  pair_edges wide rows: RHG(n={n}, avg_deg=16, gamma=2.2) at P=16, capacity "
          f"{plan.capacity}, {waves} waves of {B} rows streamed, each equal to the plain "
          f"version; {edges} edges, average degree {2 * edges / n:.3f} "
          f"({time.perf_counter() - t0:.1f}s)")
    del tables, sched, valid, keeps
    torch.cuda.empty_cache()


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


def floats_sha256(x) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(x.cpu().numpy(), "<f8").tobytes()).hexdigest()


def phase_golden_geom(dev) -> None:
    """Phase 2, geometric: edge and point digests of the JAX package, and
    the card's RHG features against the reference's, bit for bit."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels.geom.ref import hyp_features, hyp_radius_theta

    doc = json.loads((ROOT / "src" / "repro_torch" / "golden" / "geom.json").read_text())
    for e in doc["generate"]:
        spec = getattr(api, e["family"])(**e["params"])
        edges = api.generate(spec, e["P"], device=dev).edges
        require(len(edges) == e["m"] and sha256_edges(edges) == e["sha256"],
                f"golden generate {e['family']} {e['params']} P={e['P']}")
    for e in doc["points"]:
        spec = getattr(api, e["family"])(**e["params"])
        pts = torch.cat([c.points() for c in api.iter_points(spec, e["P"], device=dev, batch=64)])
        require(e["what"] == "points" and len(pts) == e["n"]
                and floats_sha256(pts) == e["sha256"],
                f"golden iter_points {e['family']} {e['params']}")
    f = doc["rhg_features"]
    plan = getattr(api, f["family"])(**f["params"]).plan(1)
    idx = np.asarray(f["rows"])
    key = torch.from_numpy(plan.key_a[0, idx].view(np.int32)).to(dev)
    geom = torch.from_numpy(plan.geom_a[0, idx]).to(dev)
    alpha = torch.from_numpy(plan.fparams[0, idx, 0]).to(dev)
    N = plan.capacity
    # the plain version on the card; the pair_edges kernel computes the same
    # features with libm.cuh's device functions, which phase 1 holds to
    # these plain ones bit for bit
    got = torch.cat([hyp_features(key, geom, alpha, N),
                     hyp_radius_theta(key, geom, alpha, N)[0][..., None]], dim=-1).cpu().numpy()
    valid = np.arange(N)[None, :] < plan.count_a[0, idx][:, None]
    want = np.array([[float.fromhex(x) for x in slot] for row in f["values"] for slot in row])
    got = got[valid]
    differ = {k: int((got[:, i].view(np.int64) != want[:, i].view(np.int64)).sum())
              for i, k in enumerate(f["features"])}
    require(not any(differ.values()), f"RHG features on the card differ from the reference's "
                                      f"(slots differing per feature: {differ})")
    print(f"  golden: {len(doc['generate'])} RGG/RHG edge digests, {len(doc['points'])} point "
          f"digests (RHG radii and angles) equal; RHG features of {len(want)} slots on the card "
          f"equal the reference's bit for bit")


def no_duplicates(key) -> bool:
    import torch
    s = torch.sort(key).values
    return not bool((s[1:] == s[:-1]).any())


# device kernel name -> group in the time breakdown: the port's kernels by
# their exact names, then any other kernel with "sort" in its name as
# torch.sort (its radix sort has a histogram kernel of its own)
KERNEL_GROUPS = {
    "sample_draw_kernel": "chunk_sample", "sample_offsets_kernel": "chunk_sample",
    "sample_scatter_kernel": "chunk_sample", "sample_bucket_kernel": "chunk_sample",
    "sample_plan_kernel": "chunk_sample", "sample_copy_kernel": "chunk_sample",
    "sample_merge_kernel": "chunk_sample", "sample_rounds_kernel": "chunk_sample",
    "chunk_decode_kernel": "chunk_decode",
    "hist_kernel": "hist", "pair_mask_kernel": "pair_mask", "pair_edges_kernel": "pair_edges",
    "hyp_plan_kernel": "hyp_edges", "hyp_pass_kernel": "hyp_edges",
    "hyp_scan_kernel": "hyp_edges",
    "cell_points_kernel": "cell_points", "triangulate_kernel": "triangulate",
    "circumspheres_kernel": "circumspheres", "chunk_rmat_kernel": "chunk_rmat",
    "chunk_ba_kernel": "chunk_ba", "close_wedges_kernel": "close_wedges"}


def kernel_group(key: str) -> str:
    """The breakdown group of a profiler kernel name such as
    ``(anonymous namespace)::hist_kernel(long const*, ...)``: a port
    kernel's name as a whole word of it, else "sort" or "other"."""
    import re
    for word in re.findall(r"\w+", key):
        if word in KERNEL_GROUPS:
            return KERNEL_GROUPS[word]
    return "sort" if "sort" in key.lower() else "other"


def profiled(fn, by=None, cpu: bool = True):
    """(result, device ms by kernel group, wall s) of ``fn`` under
    torch.profiler; an empty dict when the profiler saw no device time.
    ``by`` maps a kernel name to its group (default :func:`kernel_group`);
    ``cpu=False`` records the card's activity alone (for runs of many
    small host steps, whose host events would swamp the profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or not us:
            continue
        grp = (by or kernel_group)(ev.key)
        groups[grp] = groups.get(grp, 0.0) + us / 1e3
    return out, groups, wall


def device_ms_per_call(fn, reps: int):
    """Device ms per call of ``fn`` over ``reps`` back-to-back calls, from
    the profiler (every kernel in the window); None where it saw none."""
    _, groups, _ = profiled(lambda: [fn() for _ in range(reps)])
    return sum(groups.values()) / reps if groups else None


def graph_ms_per_call(fn, calls: int) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed, timed with CUDA events (no host time between
    them)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.6f} ms"


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


def counted_collect(spec, P: int, dev, mesh=None, **kw):
    """``collect(spec, P)`` (on ``dev``, or on the ``LocalMesh`` ``mesh``
    gathered on ``dev``) with its ``hist`` launches and its non-empty
    chunks counted; requires one ``hist`` launch per non-empty chunk and
    orientation, plus one log2 histogram per section and orientation, and
    on a mesh every chunk's launch on the card of the row that streamed it
    and every partial count (degrees, triangles) summed over all the rows.
    ``CHUNK_ROW[0]`` names that row while the chunk is counted (``held_kernels``'
    ``per`` for collect's kernels)."""
    import importlib
    from repro_torch import api
    from repro_torch.distrib.runtime import stream_row
    from repro_torch.kernels import build
    from repro_torch.stats.accumulate import Partials

    cmod = importlib.import_module("repro_torch.stats.collect")
    real, real_hist, real_sum = api.iter_edge_chunks, cmod.bincount_ids, Partials.sum
    nonempty, passes, misplaced, summed = [0], [0], [], []
    D = 1 if mesh is None else mesh.size

    def chunks(*a, **k):
        passes[0] += 1
        first = passes[0] == 1      # clustering's second pass launches no hist
        for ch in real(*a, **k):
            CHUNK_ROW[0] = stream_row(P, D, ch.pe)
            if first:
                nonempty[0] += ch.count > 0 if ch.count is not None else bool(ch.mask.any())
            yield ch

    def hist(ids, n, out=None):
        card = dev if mesh is None else mesh.devices[CHUNK_ROW[0]]
        if ids.device != card or out is None or out.device != card:
            misplaced.append((ids.device, None if out is None else out.device, card))
        return real_hist(ids, n, out=out)

    def partial_sum(self):
        summed.append(len(self.parts))
        return real_sum(self)

    before = build.LAUNCHES["hist"]
    api.iter_edge_chunks, cmod.bincount_ids, Partials.sum = chunks, hist, partial_sum
    try:
        rep = api.collect(spec, P, device=dev, mesh=mesh, **kw)
    finally:
        api.iter_edge_chunks, cmod.bincount_ids, Partials.sum = real, real_hist, real_sum
    launches = build.LAUNCHES["hist"] - before
    sides = 2 if rep.directed else 1
    require(launches == sides * (nonempty[0] + P),
            f"collect {spec} P={P}: {launches} hist launches, want one per non-empty chunk "
            f"({nonempty[0]}) plus {P} histograms, per orientation ({sides})")
    require(not misplaced, f"collect {spec} P={P}: a chunk's hist launch off its row's card "
            f"(ids, accumulator, row's card): {misplaced[:3]}")
    require(summed and set(summed) == {D}, f"collect {spec} P={P}: partial counts of "
            f"{summed} rows summed, want {D} each")
    return rep, launches, nonempty[0]


# the mesh row of the chunk that ``counted_collect`` is counting
CHUNK_ROW = [0]
# one device's collect reports of a run, by ``report_key``: path 3d's RHG
# clustering report is path 3l's one-device side where both paths run
ONE_DEVICE_REPORTS: dict = {}


def report_key(spec, P: int, kw: dict) -> tuple:
    return spec, P, tuple(sorted(kw.items()))


def sampler_rounds(fn):
    """(result of ``fn``, each sampler call's rounds tensor): the engine's
    sampler asked for every row's redraw rounds, which the kernel counts on
    the device; read them after the run."""
    import torch
    from repro_torch.distrib import engine

    real, seen = engine.sample_rows, []

    def counted(key, universe, count, capacity):
        seen.append(torch.zeros(key.shape[0], dtype=torch.int32, device=key.device))
        return real(key, universe, count, capacity, seen[-1])

    engine.sample_rows = counted
    try:
        return fn(), seen
    finally:
        engine.sample_rows = real


def round_summary(seen) -> str:
    rounds = [int(r.max()) for r in seen if r.numel()]
    return (f"{len(seen)} sampler calls, at most {max(rounds, default=0)} redraw rounds a row "
            f"(counted on the device)")


def phase_main(dev, sizes: dict) -> dict:
    """Phase 3: the main path at full width; returns what phase 4 needs."""
    import torch
    from repro_torch import api
    from repro_torch.kernels.hist.ops import LOG2_BINS, log2_histogram
    from repro_torch.kernels.hist.ref import hist_counts_ref

    n, m = sizes["gnm_n"], sizes["gnm_m"]
    spec = api.GNM(n=n, m=m, seed=1)
    t0 = time.perf_counter()
    plan = spec.plan(1)
    plan_s = time.perf_counter() - t0
    (g, seen), groups, wall = profiled(lambda: sampler_rounds(
        lambda: api.generate(spec, 1, device=dev)))
    e = g.edges
    require(g.m == m, f"generate holds {g.m} edges, want {m}")
    require(bool((e[:, 0] > e[:, 1]).all()), "generate: an edge without u > v")
    require(no_duplicates(e[:, 0] * n + e[:, 1]), "generate: duplicate edges")
    print(f"  generate GNM(n={n}, m={m}) P=1: {plan.chunks_per_pe} chunks, capacity "
          f"{plan.capacity}, {round_summary(seen)}, wall {wall:.3f}s (host plan "
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
    (rep, hl, nc), groups, cwall = profiled(lambda: counted_collect(cspec, 1, dev))
    d = rep.degree
    require(int(d.log2_hist.sum()) == cn, "collect: log2 histogram does not sum to n")
    require(d.deg_sum == 2 * rep.num_edges, "collect: degree sum is not twice the edges")
    require(torch.equal(log2_histogram(d.degrees), hist_counts_ref(d.degrees, LOG2_BINS, log2=True)),
            "collect: hist kernel differs from its plain version on the degrees")
    print(f"  collect GNP(n={cn}) P=1: {rep.num_edges} edges, mean degree "
          f"{rep.mean_degree:.4f}, max {d.deg_max}, {cwall:.3f}s; {hl} hist launches for "
          f"{nc} non-empty chunks")
    print_breakdown("collect", groups, cwall)
    return {"plan": plan, "collect_spec": cspec}


# splitmix64's multipliers as int64 bit patterns, for an order-free edge checksum
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9 - (1 << 64), 0x94D049BB133111EB - (1 << 64)


def edge_checksum(e) -> int:
    """Order-free checksum of an edge list: the int64 (wrapping) sum of a
    mix of each edge."""
    h = e[:, 0] * _MIX1 + e[:, 1]
    h = (h ^ (h >> 31)) * _MIX2
    return int((h ^ (h >> 29)).sum())


def pair_program_points(spec, dev):
    """float32 ``[n, dim]`` RGG points in vertex-id order as the pair
    program decodes them: ``(cell + u) / g`` (``Graph.points`` multiplies
    by ``1 / g``, as the reference's cell program does, which can round
    differently)."""
    import torch
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.geom.ref import cube_draw

    pp = spec.point_plan(1)
    key, count, cell, _ = (t.reshape(-1, *t.shape[2:]) for t in plan_tensors(pp, dev))
    g = torch.tensor(pp.scale, dtype=torch.float64, device=dev)
    pts = (cube_draw(key, cell.to(torch.float64), pp.capacity, pp.dim) / g).to(torch.float32)
    slot = torch.arange(pp.capacity, device=dev)
    mask = slot[None, :] < count[:, None]
    gid = torch.from_numpy(pp.gid0.reshape(-1)).to(dev)[:, None] + slot
    out = torch.full((spec.num_vertices, pp.dim), float("nan"), dtype=torch.float32, device=dev)
    out[gid[mask]] = pts[mask]
    return out


def phase_geom(dev, sizes: dict) -> dict:
    """Phase 3b: the geometric path at full width; returns what phase 4
    needs."""
    import math
    import torch
    from repro_torch import api
    from repro_torch.kernels.pairmask.ref import euclid_tile

    n = sizes["rgg_n"]
    radius = 0.55 * math.sqrt(math.log(n) / n)
    spec = api.RGG(n=n, radius=radius, dim=2, seed=4)
    t0 = time.perf_counter()
    plan = spec.plan(1)
    plan_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    g, groups, wall = profiled(lambda: api.generate(spec, 1, device=dev, return_points=True))
    peak = torch.cuda.max_memory_allocated(dev)
    e, pts = g.edges, g.points
    m = len(e)
    require(bool((e[:, 0] > e[:, 1]).all()), "RGG: an edge without u > v")
    require(no_duplicates(e[:, 0] * n + e[:, 1]), "RGG: duplicate edges")
    require(pts.shape == (n, 2) and bool(((pts >= 0) & (pts < 1)).all()), "RGG: points off [0, 1)^2")
    # every edge's float32 squared distance, recomputed by the plain tile
    # from the points as the pair program decodes them
    pf = pair_program_points(spec, dev)
    r2 = torch.tensor(plan.fparams.reshape(-1, 2)[0, 1], dtype=torch.float32, device=dev)
    require(bool(euclid_tile(pf[e[:, 0], None], pf[e[:, 1], None], r2, 2).all()),
            "RGG: an edge longer than r")
    del pf
    slots = plan.total_pairs * plan.capacity ** 2
    print(f"  generate RGG(n={n}, r={radius:.6g}) P=1: {plan.total_pairs} candidate pairs, "
          f"capacity {plan.capacity}, {slots} slots, {m} edges ({m / slots:.4f} of the slots), "
          f"wall {wall:.3f}s (host pair plan {plan_s:.3f}s), {m / wall:.4g} edges/s, "
          f"peak device memory {peak / 2**30:.3f} GiB")
    print_breakdown("RGG generate", groups, wall)
    del g, e, pts
    torch.cuda.empty_cache()

    def points():
        total = waves = 0
        for ch in api.iter_points(spec, 1, device=dev, batch=sizes["batch"]):
            p = ch.points()
            require(bool(((p >= 0) & (p < 1)).all()), "iter_points: a point off [0, 1)^2")
            total += len(p)
            waves += 1
        return total, waves

    (total, waves), groups, pwall = profiled(points)
    require(total == n, f"iter_points: {total} points, want {n}")
    print(f"  iter_points RGG P=1: {waves} waves of up to {sizes['batch']} cells, "
          f"{total} points, {pwall:.3f}s")
    print_breakdown("iter_points", groups, pwall)

    hn, P = sizes["rhg_n"], 16
    hspec = api.RHG(n=hn, avg_deg=16.0, gamma=2.8, seed=5)
    t0 = time.perf_counter()
    hplan = hspec.plan(P)
    hplan_s = time.perf_counter() - t0

    def stream():
        total = waves = chk = 0
        for ch in api.iter_edge_chunks(hspec, P, device=dev, batch=sizes["batch"]):
            ce = ch.edges()
            require(bool((ce[:, 0] > ce[:, 1]).all()), f"RHG stream of PE {ch.pe}: u <= v")
            total += len(ce)
            chk = (chk + edge_checksum(ce)) % (1 << 64)
            waves += 1
        return total, waves, chk

    (total, waves, chk), groups, swall = profiled(stream)
    print(f"  stream RHG(n={hn}) P={P}: {hplan.total_pairs} candidate pairs in {waves} waves "
          f"of up to {sizes['batch']}, capacity {hplan.capacity}, {total} edges, {swall:.3f}s "
          f"(host pair plan {hplan_s:.3f}s), {total / swall:.4g} edges/s (checks included)")
    print_breakdown("RHG stream", groups, swall)

    torch.cuda.reset_peak_memory_stats(dev)
    h, groups, hwall = profiled(lambda: api.generate(hspec, 1, device=dev))
    hpeak = torch.cuda.max_memory_allocated(dev)
    he = h.edges
    require(len(he) == total and edge_checksum(he) % (1 << 64) == chk,
            "RHG: the edges at P=1 differ from the stream at P=16")
    require(bool((he[:, 0] > he[:, 1]).all()), "RHG: an edge without u > v")
    require(no_duplicates(he[:, 0] * hn + he[:, 1]), "RHG: duplicate edges")
    mean = 2 * len(he) / hn
    require(abs(mean - 16.0) < 1.0, f"RHG: mean degree {mean}, want about 16")
    print(f"  generate RHG(n={hn}) P=1: {len(he)} edges, mean degree {mean:.4f}, wall "
          f"{hwall:.3f}s, {len(he) / hwall:.4g} edges/s, peak device memory "
          f"{hpeak / 2**30:.3f} GiB; same edges as the P={P} stream")
    print_breakdown("RHG generate", groups, hwall)
    hdeg = torch.bincount(he.reshape(-1), minlength=hn)
    del h, he
    torch.cuda.empty_cache()

    (rep, hl, nc), groups, cwall = profiled(
        lambda: counted_collect(hspec, P, dev, batch=sizes["batch"]))
    d = rep.degree
    require(rep.num_edges == total, f"collect RHG: {rep.num_edges} edges, stream {total}")
    require(d.deg_sum == 2 * total and int(d.log2_hist.sum()) == hn,
            "collect RHG: degree sum or histogram off")
    require(torch.equal(d.degrees, hdeg), "collect RHG: degrees differ from the P=1 edges'")
    print(f"  collect RHG(n={hn}) P={P}: mean degree {rep.mean_degree:.4f}, max {d.deg_max}, "
          f"{cwall:.3f}s; {hl} hist launches for {nc} non-empty waves")
    print_breakdown("RHG collect", groups, cwall)
    return {"rgg_plan": plan, "rgg_spec": spec, "rhg_plan": hplan, "rhg_spec": hspec}


# the reference's oracles hand pair_mask cells padded to 128 rows of 8
# columns: +inf coordinates (euclid), or a feature row adjacent to
# nothing (hyp: coth r = 1e30)
MASK_ROWS = 128
EUCLID_PAD_ROW = (float("inf"),) * 8
HYP_PAD_ROW = (0.0, 0.0, 1e30, 0.0, 0.0, 0.0, 0.0, 0.0)


def oracle_blocks(vals, count, pad_row):
    """``[R, 128, 8]`` blocks of the oracles' pair_mask calls: the
    ``count`` valid rows of ``vals [R, cap, k]`` in the first ``k``
    columns, every other entry from ``pad_row``."""
    import torch
    R, cap, k = vals.shape
    pad = torch.tensor(pad_row, dtype=vals.dtype, device=vals.device)
    out = pad.repeat(R, MASK_ROWS, 1)
    valid = torch.arange(cap, device=vals.device)[None, :, None] < count[:, None, None]
    out[:, :cap, :k] = torch.where(valid, vals, pad[:k])
    return out


def mask_to_keep(mask, rows, kind_code, cap):
    """The pair program's keep ``[R, cap^2]`` from a pair_mask ``[R, 128,
    128]`` over the rows' oracle blocks: the mask's valid corner, once on
    a self pair, on active rows of ``kind_code``."""
    import torch
    kind, self_pair, active = rows[0], rows[-2], rows[-1]
    ii = torch.arange(cap, device=mask.device)
    once = ~self_pair[:, None, None] | (ii[None, :, None] < ii[None, None, :])
    live = (active & (kind == kind_code))[:, None, None]
    return (mask[:, :cap, :cap].bool() & once & live).reshape(len(kind), cap * cap)


def geom_timing(dev, main: dict, errs: Errors) -> list:
    """Phase 4, geometric kernels at their main-path shapes (pair_mask at
    its contract's shape over the main path's own cells)."""
    import torch
    from repro_torch.distrib.runtime import plan_tensors, wave_schedule
    from repro_torch.kernels.geom import ops as G
    from repro_torch.kernels.geom.ref import (GEOM_HYP, GEOM_TORUS, cube_draw, cell_points_ref,
                                              hyp_features, pair_edges_ref)
    from repro_torch.kernels.pairmask.ops import pair_mask
    from repro_torch.kernels.pairmask.ref import pair_mask_ref

    def pair_rows(plan, sel=None):
        t = [x.reshape(-1, *x.shape[2:]) for x in plan_tensors(plan, dev)]
        return t if sel is None else [x[sel] for x in t]

    rows = []
    # RGG at its generate shape: the kernel alone over every candidate pair
    # of the P=1 plan in one launch, each call's 43 GB of output dropped as
    # it returns (the plain version's temporaries would not fit), then
    # kernel == plain on a slice of those rows
    plan = main["rgg_plan"]
    full = pair_rows(plan)
    cap = plan.capacity
    kw = dict(capacity=cap, dim=plan.dim, kinds=plan.kinds_present)
    _, rgg_ms, rgg_med = timed(lambda: G.pair_edges(*full, **kw) and None, reps=3,
                               label="pair_edges, RGG generate shape")
    slots = plan.active.size * cap ** 2
    points = int(((full[3] + full[4]) * full[-1]).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in full)
    rgg_bytes, rgg_ops = (x * 1e3 for x in bound_terms(
        cost().pair_edges(in_bytes, plan.active.size, cap, points)))
    rgg_bound = max(rgg_bytes, rgg_ops)
    print(f"  pair_edges at the RGG generate shape: {plan.active.size} rows x "
          f"{cap}^2 slots: median {rgg_med:.3f} ms one at a time (mean {rgg_ms:.3f}), bound "
          f"{rgg_bound:.3f} ms ({'bytes' if rgg_bytes >= rgg_ops else 'operations'}; "
          f"bytes {rgg_bytes:.3f}, Threefry {rgg_ops:.3f}): {100 * rgg_bound / rgg_med:.1f} % "
          f"of the bound")
    part = [t[:1 << 15] for t in full]
    del full
    torch.cuda.empty_cache()
    ea, rgg_keep = G.pair_edges(*part, **kw)
    eb, kb = pair_edges_ref(*part, **kw)
    errs.same("pair_edges", ea, eb, "pair_edges edges on 32768 rows of the RGG plan")
    errs.same("pair_edges", rgg_keep, kb, "pair_edges keep on 32768 rows of the RGG plan")
    require(bool(rgg_keep.any()), "pair_edges: no edge kept on the RGG rows")
    del ea, eb, kb

    # pair_mask over the same rows' cells, as rgg_pe would block them: its
    # euclid mask decides pair_edges' keep
    kind, key_a, key_b, count_a, count_b, _, _, geom_a, geom_b, fparams = part[:10]
    g = fparams[:, 0, None, None]
    a = oracle_blocks((cube_draw(key_a, geom_a, cap, 2) / g).to(torch.float32), count_a,
                      EUCLID_PAD_ROW)
    b = oracle_blocks((cube_draw(key_b, geom_b, cap, 2) / g).to(torch.float32), count_b,
                      EUCLID_PAD_ROW)
    r2 = float(fparams[0, 1])
    out, ms, med = timed(lambda: pair_mask(a, b, r2, tile="euclid", dim=2), label="pair_mask")
    ref, plain_ms = sync_time(lambda: pair_mask_ref(a, b, r2, tile="euclid", dim=2), reps=1)
    errs.same("pair_mask", out, ref, "pair_mask euclid at its contract's shape")
    require(torch.equal(mask_to_keep(out, part, GEOM_TORUS, cap), rgg_keep),
            "pair_mask euclid disagrees with pair_edges' keep on the RGG rows")
    # read each point row once, write one byte per pair; 2 subtractions,
    # a multiply, an FMA (2) and a compare per pair
    rows.append(("pair_mask", "src/repro_torch/kernels/pairmask/csrc/pairmask.cu",
                 "src/repro/kernels/pairmask/pairmask.py:56", ms, med, plain_ms,
                 *bound_terms(cost().pair_mask(a.numel(), b.numel(), out.numel())), None))
    print(f"  pair_mask shape: euclid [{a.shape[0]}, {MASK_ROWS}, 8] x same, the "
          f"cells of the first {a.shape[0]} RGG pair rows in the oracles' blocks; its mask "
          f"equals pair_edges' keep there")
    del out, ref, a, b, part, rgg_keep
    torch.cuda.empty_cache()

    # the streamed RHG wave: the first wave of the P=16 plan
    hplan = main["rhg_plan"]
    ws = wave_schedule(hplan, 1, FULL["batch"])
    s = torch.from_numpy(ws.sched[0, 0][ws.valid[0, 0]]).to(dev, torch.int64)
    wave = pair_rows(hplan, s[:, 0] * hplan.pairs_per_pe + s[:, 1])
    cap = hplan.capacity
    kw = dict(capacity=cap, dim=hplan.dim, kinds=hplan.kinds_present)
    (ea, ka), ms, med = timed(lambda: G.pair_edges(*wave, **kw), reps=20,
                              label="pair_edges, RHG wave")
    (eb, kb), plain_ms = sync_time(lambda: pair_edges_ref(*wave, **kw), reps=1)
    errs.same("pair_edges", ea, eb, "pair_edges edges at the RHG wave shape")
    errs.same("pair_edges", ka, kb, "pair_edges keep at the RHG wave shape")
    R, slots = len(s), ka.numel()
    live = wave[-1]
    points = int(((wave[3] + wave[4]) * live).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in wave)
    # 17 bytes written per slot; 1 + 2*2 Threefry blocks per regenerated point
    # (the transcendentals of the hyperbolic features are not counted)
    wave_bytes, wave_ops = bound_terms(cost().pair_edges(in_bytes, R, cap, points))
    rows.append(("pair_edges", "src/repro_torch/kernels/geom/csrc/geom.cu",
                 "src/repro/distrib/engine.py:1050", ms, med, plain_ms, wave_bytes,
                 wave_ops, None))
    dev_ms = graph_ms_per_call(lambda: G.pair_edges(*wave, **kw), 20)
    # the stores alone: every row inactive, so nothing is decoded
    idle = wave[:-1] + [torch.zeros_like(live)]
    _, _, idle_med = timed(lambda: G.pair_edges(*idle, **kw), reps=20)
    print(f"  pair_edges shape: one RHG wave, {R} rows x {cap}^2 slots, "
          f"{points} points regenerated, {int(ka.sum())} edges kept; median {med:.6f} ms "
          f"(device {dev_ms:.6f} ms a call, graph replay; {idle_med:.6f} with every row "
          f"inactive), byte bound {wave_bytes * 1e3:.6f} ms: {100 * wave_bytes * 1e3 / med:.1f} "
          f"% of it")
    del ea, eb, kb

    # pair_mask's hyp tile over the wave's first 8192 rows, as
    # rhg._adjacency would block them: its mask decides pair_edges' keep
    part = [t[:1 << 13] for t in wave]
    kind, key_a, key_b, count_a, count_b, _, _, geom_a, geom_b, fparams = part[:10]
    q = oracle_blocks(hyp_features(key_a, geom_a, fparams[:, 0], cap), count_a, HYP_PAD_ROW)
    c = oracle_blocks(hyp_features(key_b, geom_b, fparams[:, 0], cap), count_b, HYP_PAD_ROW)
    live = (kind == GEOM_HYP).nonzero()
    require(len(live) > 0, "the RHG wave holds no hyperbolic row")
    cosh_r = float(fparams[live[0, 0], 1])
    out = pair_mask(q, c, cosh_r, tile="hyp")
    errs.same("pair_mask", out, pair_mask_ref(q, c, cosh_r, tile="hyp"),
              "pair_mask hyp at its contract's shape")
    require(torch.equal(mask_to_keep(out, part, GEOM_HYP, cap), ka[:len(kind)]),
            "pair_mask hyp disagrees with pair_edges' keep on the RHG rows")
    del out, q, c, part, wave, ka
    torch.cuda.empty_cache()

    for tag, spec in (("RGG", main["rgg_spec"]), ("RHG", main["rhg_spec"])):
        pp = spec.point_plan(1)
        prow = pair_rows(pp)
        kw = dict(kind=pp.kind, scale=pp.scale, capacity=pp.capacity, dim=pp.dim)
        (pa, ma), ms, med = timed(lambda: G.cell_points(*prow, **kw), reps=20,
                                  label=f"cell_points, {tag} point plan")
        (pb, mb), plain_ms = sync_time(lambda: cell_points_ref(*prow, **kw), reps=1)
        errs.same("cell_points", pa, pb, f"cell_points at the {tag} point-plan shape")
        errs.same("cell_points", ma, mb, f"cell_points mask at the {tag} point-plan shape")
        cells, cap, dim = pa.shape
        drawn = int(prow[1].sum())
        in_bytes = sum(t.numel() * t.element_size() for t in prow)
        # every slot written once; 1 + 2 dim Threefry blocks per point (the
        # polar decode's arccosh is not counted)
        bytes_s, ops_s = bound_terms(cost().cell_points(in_bytes, cells, cap, dim, drawn))
        if tag == "RGG":
            rows.append(("cell_points", "src/repro_torch/kernels/geom/csrc/geom.cu",
                         "src/repro/distrib/engine.py:644", ms, med, plain_ms, bytes_s, ops_s,
                         None))
        bound = max(bytes_s, ops_s) * 1e3
        # device time alone: at tens of µs the event pairs also time the
        # wrapper's host work between them
        dev_ms = graph_ms_per_call(lambda: G.cell_points(*prow, **kw), 20)
        # the stores alone: every count 0, so nothing is drawn
        empty = [prow[0], torch.zeros_like(prow[1])] + prow[2:]
        _, _, empty_med = timed(lambda: G.cell_points(*empty, **kw), reps=20)
        print(f"  cell_points shape: {tag} point plan, {cells} cells x {cap} slots x {dim}, "
              f"{drawn} points; median {med:.6f} ms (mean {ms:.6f}; device {dev_ms:.6f} ms a "
              f"call, graph replay; {empty_med:.6f} with every count 0), plain {plain_ms:.3f} "
              f"ms, bound {bound:.6f} ms ({'bytes' if bytes_s >= ops_s else 'operations'}): "
              f"{med / bound:.2f}x the bound")
        del pa, ma, pb, mb, prow
        torch.cuda.empty_cache()
    return rows


def sampler_timing(dev, plan, errs: Errors, label: str):
    """The collision sampler at a plan's sampled rows: its kernel in turns
    with ``torch.sort`` of the same rows (kernel, sort, sort, kernel), the
    plain version by groups of rows (each row is independent), the bound
    (three Threefry blocks a drawn slot, 8 bytes a slot written) and the
    bytes the design moves.  Returns (kernels-line row, sorted values)."""
    import re
    import torch
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import sample_rows_ref

    kind, key, uni, cnt, *_ = (t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev))
    R, cap = kind.numel(), plan.capacity
    sampled = (kind >= 1) & (kind <= 3)     # DIRECTED, TRI, RECT, as the engine passes them
    cnt = torch.where(sampled, cnt, 0)
    rounds = torch.zeros(R, dtype=torch.int32, device=dev)
    vals = S.chunk_sample(key, uni, cnt, cap, rounds)
    sample = lambda: S.chunk_sample(key, uni, cnt, cap)     # noqa: E731
    lib = lambda: torch.sort(vals, dim=-1)                  # noqa: E731
    turns = [timed(f, reps=5, label=f"{k} [{R}, {cap}] {label}")[1:] for k, f in (
        ("chunk_sample", sample), ("torch.sort", lib), ("torch.sort", lib),
        ("chunk_sample", sample))]
    ms, lib_ms = (turns[0][0] + turns[3][0]) / 2, (turns[1][0] + turns[2][0]) / 2
    med, lib_med = (turns[0][1] + turns[3][1]) / 2, (turns[1][1] + turns[2][1]) / 2
    _, parts, _ = profiled(sample, by=lambda k: next(
        (w for w in re.findall(r"\w+", k) if w.startswith("sample_")), "other"))
    print(f"  chunk_sample {label} device ms by kernel (profiler, one call): "
          + (", ".join(f"{k} {v:.3f}" for k, v in sorted(parts.items())) or "not measured"))
    torch.cuda.empty_cache()
    plain_ms, group = 0.0, max(1, (1 << 26) // cap)
    for lo in range(0, R, group):
        rows_ = slice(lo, lo + group)
        want, g_ms = sync_time(lambda: sample_rows_ref(key[rows_], uni[rows_], cnt[rows_], cap),
                               reps=1)
        errs.same("chunk_sample", vals[rows_], want, f"chunk_sample {label} rows {lo}+")
        plain_ms += g_ms
        del want
    torch.cuda.empty_cache()
    slots, drawn = R * cap, int(cnt.clamp(0, cap).sum())
    out_s, ops = bound_terms(cost().chunk_sample(R, cap, drawn))
    # slot-order draws written, read and bucketed, each bucket read and
    # written once, sentinels written once; the rounds' stretches on top
    design = drawn * 40 + (slots - drawn) * 8
    print(f"  chunk_sample {label}: [{R}, {cap}], {drawn} drawn slots, redraw rounds a row "
          f"{torch.bincount(rounds).tolist()} (rows with 0, 1, ...); median {med:.6f} ms "
          f"(mean {ms:.6f}) against torch.sort of the same rows {lib_med:.6f} (mean {lib_ms:.6f}); "
          f"bound {max(ops, out_s) * 1e3:.6f} ms (operations "
          f"{ops * 1e3:.6f}, bytes {out_s * 1e3:.6f}); the design moves "
          f"at least {design / 1e9:.3f} GB ({bound_terms(cost().Cost(design))[0] * 1e3:.6f} ms at 3.35 TB/s) "
          f"plus a scratch buffer of {slots * 8 / 2**30:.3f} GiB; plain version {plain_ms:.3f} ms")
    row = ("chunk_sample", "src/repro_torch/kernels/sampler/csrc/collision.cu",
           "src/repro/core/sampling.py:91-133", ms, med, plain_ms,
           out_s, ops, lib_ms)
    return row, vals


def phase_timing(dev, main: dict, errs: Errors) -> list:
    """Phase 4: each kernel at its main-path shape."""
    import torch
    from repro_torch import api
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.hist.ops import bincount_ids
    from repro_torch.kernels.hist.ref import hist_counts_ref
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import chunk_decode_ref

    plan = main["plan"]
    kind, key, uni, cnt, params, _, owned = (
        t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev))
    cap = plan.capacity
    slots = kind.numel() * cap
    row, vals = sampler_timing(dev, plan, errs, "GNM generate")
    rows = [row]

    (ea, ka), ms, med = timed(lambda: S.chunk_decode(vals, kind, params, cnt, owned), reps=10,
                             label="chunk_decode")
    (eb, kb), plain_ms = sync_time(lambda: chunk_decode_ref(vals, kind, params, cnt, owned), reps=1)
    errs.same("chunk_decode", ea, eb, "chunk_decode at full width")
    errs.same("chunk_decode", ka, kb, "chunk_decode keep at full width")
    del ea, ka, eb, kb, vals
    rows.append(("chunk_decode", "src/repro_torch/kernels/sampler/csrc/sampler.cu",
                 "src/repro/core/sampling.py:155", ms, med, plain_ms,
                 *bound_terms(cost().chunk_decode(kind.numel(), cap)), None))
    torch.cuda.empty_cache()

    # collect adds each chunk's endpoint ids into its section's degree
    # array in place (the first chunk's ids are that launch's shape);
    # index_add_ is the one library call computing the same function
    cspec = main["collect_spec"]
    ids = next(api.iter_edge_chunks(cspec, 1, device=dev)).edges().reshape(-1)
    bins = cspec.n
    acc = torch.zeros(bins, dtype=torch.int64, device=dev)
    ones = torch.ones_like(ids)
    # back-to-back calls from Python (host and device), the kernel and
    # index_add_ in turns (kernel, library, library, kernel) because the
    # host's pace drifts; then the device time per call, by the profiler
    # and by replaying 100 captured calls
    hist_call = lambda: bincount_ids(ids, bins, out=acc)       # noqa: E731
    lib_call = lambda: acc.index_add_(0, ids, ones)            # noqa: E731
    turns = [timed(f, reps=100, label=k)[1:] for k, f in (
        ("hist kernel, host loop", hist_call), ("hist index_add_, host loop", lib_call),
        ("hist index_add_, host loop", lib_call), ("hist kernel, host loop", hist_call))]
    ms, lib_ms = (turns[0][0] + turns[3][0]) / 2, (turns[1][0] + turns[2][0]) / 2
    med = (turns[0][1] + turns[3][1]) / 2            # the two kernel turns' medians
    _, plain_ms = sync_time(lambda: acc.add_(hist_counts_ref(ids, bins, drop=True)), reps=10)
    _, bincount_ms = sync_time(lambda: torch.bincount(ids, minlength=bins), reps=10)
    dev_ms = {k: (device_ms_per_call(f, 50), graph_ms_per_call(f, 100))
              for k, f in (("kernel", hist_call), ("index_add_", lib_call))}
    errs.same("hist", bincount_ids(ids, bins), hist_counts_ref(ids, bins, drop=True),
              "hist at its main-path shape")
    touched = int(torch.unique(ids).numel())
    # each id read once, each touched bin's count read and written once
    bound, _ = bound_terms(cost().hist(ids.numel(), touched))
    rows.append(("hist", "src/repro_torch/kernels/hist/csrc/hist.cu",
                 "src/repro/kernels/hist/hist.py:54", ms, med, plain_ms, bound, 0.0, lib_ms))
    print(f"  hist shape: {ids.numel()} ids into {bins} bins ({touched} touched); host loop "
          f"kernel {ms:.6f} ms, index_add_ {lib_ms:.6f} ms, torch.bincount (new array) "
          f"{bincount_ms:.6f} ms; device time per call (profiler; graph replay) kernel "
          f"{fmt_ms(dev_ms['kernel'][0])}; {dev_ms['kernel'][1]:.6f} ms, index_add_ "
          f"{fmt_ms(dev_ms['index_add_'][0])}; {dev_ms['index_add_'][1]:.6f} ms, byte bound "
          f"{bound * 1e3:.6f} ms")

    return rows


DT_ROWS = {2: 256, 3: 192}
# the golden specs of rdg.json (2-D: one batched round; 3-D: two, then Qhull)
RDG_GOLDEN_2D = dict(n=1 << 13, dim=2, seed=21)
RDG_GOLDEN_3D = dict(n=1 << 13, dim=3, seed=22)


def dt_check(dev, errs: Errors, pts, cnt, dim: int, what: str) -> None:
    """triangulate on the card against its plain version on the same rows:
    ``ok`` on every row, ``simp``, ``alive`` and the trip counts on every
    ``ok`` row (a row that is not ok stops early on the card)."""
    import torch
    from repro_torch.kernels.delaunay import ops as D
    from repro_torch.kernels.delaunay.ref import triangulate_ref

    pts = torch.as_tensor(pts, dtype=torch.float64, device=dev).contiguous()
    cnt = torch.as_tensor(cnt, dtype=torch.int64, device=dev)
    N = pts.shape[1]
    kw = dict(dim=dim, num_simplices=D.simplex_capacity(N, dim), cavity=D.cavity_capacity(dim),
              group=D.group_size(dim))
    wk = torch.zeros((len(cnt), 2), dtype=torch.int64, device=dev)
    wp = torch.zeros_like(wk)
    ks, ka, ko = D.triangulate(pts, cnt, work=wk, **kw)
    ps, pa, po = triangulate_ref(pts, cnt, work=wp, **kw)
    errs.same("triangulate", ko, po, f"triangulate ok, {what}")
    errs.same("triangulate", ks[po], ps[po], f"triangulate simp, {what}")
    errs.same("triangulate", ka[po], pa[po], f"triangulate alive, {what}")
    errs.same("triangulate", wk[po], wp[po], f"triangulate trips, {what}")


def first_round_rows(spec, dev):
    """The [B, N] rows of the first halo round of ``spec``'s planning."""
    from repro_torch.core import rdg

    captured = []
    real = rdg.batched_delaunay

    def capture(points, counts, **kw):
        if not captured:
            captured.append((points, counts))
        return real(points, counts, **kw)

    rdg.rdg_structure.cache_clear()
    rdg.batched_delaunay = capture
    try:
        spec.plan(1, device=dev)
    finally:
        rdg.batched_delaunay = real
        rdg.rdg_structure.cache_clear()
    return captured[0]


def phase_dt_kernels(dev, errs: Errors) -> None:
    """Phase 1, Delaunay: triangulate on random, padded, degenerate and real
    RDG rows; circumspheres; the CERT rows of pair_edges; all exact."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.delaunay import ops as D
    from repro_torch.kernels.delaunay.predicates import circumsphere
    from repro_torch.kernels.geom import ops as G
    from repro_torch.kernels.geom.ref import pair_edges_ref

    rng = np.random.default_rng(11)
    for dim, N in DT_ROWS.items():
        pts = rng.random((8, N, dim))
        cnt = rng.integers(dim + 2, N + 1, 8)
        cnt[[2, 5]] = [0, N]
        pts[3, 40:50] = pts[3, :10]                      # repeated points
        dt_check(dev, errs, pts, cnt, dim, f"random {dim}-D rows [8, {N}]")
    sq = [[[0.2, 0.2], [0.8, 0.2], [0.8, 0.8], [0.2, 0.8]]]
    dt_check(dev, errs, sq, [4], 2, "a cocircular square")
    line = np.stack([np.linspace(0.1, 0.9, 5), np.full(5, 0.5)], axis=1)[None]
    dt_check(dev, errs, line, [5], 2, "collinear points")
    flat = rng.random((1, 16, 3))
    flat[..., 2] = 0.5
    dt_check(dev, errs, flat, [16], 3, "coplanar points")
    golden = api.RDG(**RDG_GOLDEN_2D)
    pts, cnt = first_round_rows(golden, dev)
    dt_check(dev, errs, pts, cnt, 2, f"the first halo round of {golden} {tuple(pts.shape)}")

    for dim in (2, 3):
        s = torch.rand((1 << 17, dim + 1, dim), dtype=torch.float64, device=dev)
        s[0, 1] = s[0, 0]
        for a, b, name in zip(D.circumspheres(s), circumsphere(s, fused=False),
                              ("center", "r2", "nondeg")):
            errs.same("circumspheres", a, b, f"circumspheres {name} {dim}-D")
    for kw in (RDG_GOLDEN_2D, RDG_GOLDEN_3D):
        plan = api.RDG(**kw).plan(4, device=dev)
        rows = [t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev)]
        kwp = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
        ea, ka = G.pair_edges(*rows, **kwp)
        eb, kb = pair_edges_ref(*rows, **kwp)
        errs.same("pair_edges", ea, eb, f"pair_edges CERT edges {kw}")
        errs.same("pair_edges", ka, kb, f"pair_edges CERT keep {kw}")
        require(int(ka.sum()) > 0, f"pair_edges CERT {kw}: no edge kept")


def array_sha256(a) -> str:
    import numpy as np
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.astype(a.dtype.newbyteorder("<")).tobytes()).hexdigest()


PAIR_FIELDS = ("kind", "key_a", "key_b", "count_a", "count_b", "gid_a", "gid_b",
               "geom_a", "geom_b", "fparams", "self_pair", "active")


def phase_golden_rdg(dev) -> None:
    """Phase 2, RDG: edge, plan-table and point digests and the planning
    path of every rdg.json entry, recomputed on the card."""
    from repro_torch import api
    from repro_torch.core import rdg

    doc = json.loads((ROOT / "src" / "repro_torch" / "golden" / "rdg.json").read_text())
    for e in doc["generate"]:
        rdg.rdg_structure.cache_clear()
        spec = getattr(api, e["family"])(**e["params"])
        plan = spec.plan(e["P"], device=dev)
        st = rdg.rdg_structure(spec.n, e["P"], spec.dim, "threefry2x32", 0, 8)
        g = api.generate(spec, e["P"], device=dev, return_points=True)
        got = {"m": int(len(g.edges)), "sha256": sha256_edges(g.edges),
               "points_sha256": floats_sha256(g.points),
               "tables": {f: array_sha256(getattr(plan, f)) for f in PAIR_FIELDS},
               "pairs_per_pe": int(plan.pairs_per_pe),
               "path": {"batched_rounds": st.last_rounds, "ok_rows": st.last_ok_rows,
                        "qhull_chunks": st.last_qhull_chunks}}
        for k, v in got.items():
            require(v == e[k], f"golden RDG {e['params']} P={e['P']}: {k} differs")
        print(f"  golden RDG {e['params']} P={e['P']}: {got['m']} edges, every table and the "
              f"points equal; path {got['path']}")
    rdg.rdg_structure.cache_clear()


def brute_edges(points, dim: int):
    """The periodic Delaunay graph by scipy's Qhull on the 3^d tiling of the
    torus (an own copy of the reference's ``rdg_brute_edges``): edges with
    an endpoint in the canonical copy, ids folded mod n, as int64 codes
    ``max * n + min``."""
    import itertools
    import numpy as np
    from scipy.spatial import Delaunay

    n = len(points)
    shifts = list(itertools.product((-1.0, 0.0, 1.0), repeat=dim))
    tiles = np.concatenate([points + np.array(s) for s in shifts])
    base = np.tile(np.arange(n), len(shifts))
    center = shifts.index((0.0,) * dim)
    canonical = np.zeros(len(tiles), bool)
    canonical[center * n:(center + 1) * n] = True
    simp = Delaunay(tiles).simplices
    a = np.concatenate([simp[:, i] for i, j in itertools.combinations(range(dim + 1), 2)])
    b = np.concatenate([simp[:, j] for i, j in itertools.combinations(range(dim + 1), 2)])
    keep = canonical[a] | canonical[b]
    u, v = base[a[keep]], base[b[keep]]
    u, v = u[u != v], v[u != v]
    return np.unique(np.maximum(u, v).astype(np.int64) * n + np.minimum(u, v))


def rdg_checks(e, n: int, what: str):
    """No loops, no duplicates; returns the degrees."""
    import torch
    require(bool((e[:, 0] > e[:, 1]).all()), f"{what}: an edge without u > v (or a loop)")
    require(no_duplicates(e[:, 0] * n + e[:, 1]), f"{what}: duplicate edges")
    return torch.bincount(e.reshape(-1), minlength=n)


def phase_rdg(dev, sizes: dict) -> dict:
    """Phase 3c: RDG at full width; returns the inputs phase 4 times."""
    import math
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import rdg

    captured = {}
    real_dt, real_cs = rdg.batched_delaunay, rdg.circumspheres_kernel

    def capture_dt(points, counts, **kw):
        captured.setdefault("triangulate", []).append((points, counts))
        return real_dt(points, counts, **kw)

    def capture_cs(simp):
        captured.setdefault("circumspheres", simp)
        return real_cs(simp)

    n = sizes["rdg2_n"]
    spec = api.RDG(n=n, dim=2, seed=6)
    rdg.rdg_structure.cache_clear()
    rdg.batched_delaunay, rdg.circumspheres_kernel = capture_dt, capture_cs
    try:
        plan, groups, plan_s = profiled(lambda: spec.plan(1, device=dev))
    finally:
        rdg.batched_delaunay, rdg.circumspheres_kernel = real_dt, real_cs
    st = rdg.rdg_structure(n, 1, 2, "threefry2x32", 0, 8)
    shapes = [tuple(np.shape(p)) for p, _ in captured["triangulate"]]
    print(f"  plan RDG(n={n}, dim=2) P=1: {plan.total_pairs} CERT rows, {st.last_rounds} halo "
          f"rounds of the batched kernel (shapes {shapes}; ok rows per round "
          f"{st.last_ok_rows}), {st.last_qhull_chunks} chunks on Qhull, wall {plan_s:.3f}s")
    print_breakdown("RDG 2-D plan", groups, plan_s)
    torch.cuda.reset_peak_memory_stats(dev)
    g, groups, wall = profiled(lambda: api.generate(spec, 1, device=dev, return_points=True))
    peak = torch.cuda.max_memory_allocated(dev)
    e, pts = g.edges, g.points
    deg = rdg_checks(e, n, "RDG 2-D")
    require(pts.shape == (n, 2) and bool(((pts >= 0) & (pts < 1)).all()),
            "RDG 2-D: points off [0, 1)^2")
    short = 3 * n - len(e)
    require(short == 0, f"RDG 2-D: {len(e)} edges, a torus triangulation has 3n = {3 * n} "
            f"(shortfall {short})")
    require(int(deg.min()) >= 3, f"RDG 2-D: a vertex of degree {int(deg.min())} < 3")
    chk = edge_checksum(e) % (1 << 64)
    print(f"  generate RDG(n={n}, dim=2) P=1 with points (plan cached): {len(e)} edges = 3n, "
          f"degrees {int(deg.min())}..{int(deg.max())}, wall {wall:.3f}s; cold generate "
          f"{plan_s + wall:.3f}s, {len(e) / (plan_s + wall):.4g} edges/s; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    print_breakdown("RDG 2-D generate", groups, wall)
    cert = plan
    del g, e, pts, deg
    torch.cuda.empty_cache()

    def stream():
        total = waves = c = 0
        for ch in api.iter_edge_chunks(spec, 16, device=dev, batch=sizes["batch"]):
            ce = ch.edges()
            total += len(ce)
            c = (c + edge_checksum(ce)) % (1 << 64)
            waves += 1
        return total, waves, c

    rdg.rdg_structure.cache_clear()
    (total, waves, c), groups, swall = profiled(stream)
    require(total == 3 * n and c == chk, "RDG 2-D: the stream at P=16 differs from generate")
    print(f"  stream RDG(n={n}, dim=2) P=16 (planning included): {waves} waves, {total} edges, "
          f"the same checksum as generate, {swall:.3f}s")
    print_breakdown("RDG 2-D stream", groups, swall)

    # 3-D: the batched rounds clear ok (a cavity past CAV = 96) and the
    # chunks certify on Qhull once their regions wrap, as in the reference
    n3 = sizes["rdg3_n"]
    spec3 = api.RDG(n=n3, dim=3, seed=7)
    rdg.rdg_structure.cache_clear()
    g3, groups, wall3 = profiled(lambda: api.generate(spec3, 1, device=dev))
    st3 = rdg.rdg_structure(n3, 1, 3, "threefry2x32", 0, 8)
    deg3 = rdg_checks(g3.edges, n3, "RDG 3-D")
    mean = float(deg3.double().mean())
    want = 2 + 48 * math.pi ** 2 / 35
    require(abs(mean - want) < 0.5, f"RDG 3-D: mean degree {mean}, want about {want:.4f}")
    print(f"  generate RDG(n={n3}, dim=3) P=1 (planning included): {len(g3.edges)} edges, "
          f"mean degree {mean:.4f} (Poisson-Delaunay {want:.4f}), {st3.last_rounds} halo rounds "
          f"(ok rows per round {st3.last_ok_rows}), {st3.last_qhull_chunks} chunks on Qhull, "
          f"wall {wall3:.3f}s")
    print_breakdown("RDG 3-D generate", groups, wall3)
    del g3, deg3
    rdg.rdg_structure.cache_clear()
    torch.cuda.empty_cache()

    for nb, dim, seed in ((sizes["brute2_n"], 2, 8), (sizes["brute3_n"], 3, 9)):
        spec_b = api.RDG(n=nb, dim=dim, seed=seed)
        gb = api.generate(spec_b, 1, device=dev, return_points=True)
        got = (gb.edges[:, 0] * nb + gb.edges[:, 1]).cpu().numpy()
        t0 = time.perf_counter()
        want = brute_edges(gb.points.cpu().numpy(), dim)
        sym = len(np.setxor1d(got, want))
        require(sym <= max(2, int(0.003 * len(want))),
                f"RDG({nb}, dim={dim}) against Qhull on the tiling: {sym} edges differ")
        print(f"  brute RDG(n={nb}, dim={dim}): {len(got)} edges, Qhull on the 3^{dim} tiling "
              f"{len(want)} ({time.perf_counter() - t0:.1f}s), symmetric difference {sym}")
    rdg.rdg_structure.cache_clear()
    return {"triangulate": captured["triangulate"], "circumspheres": captured["circumspheres"],
            "cert_plan": cert}


def dt_round_timing(dev, errs: Errors, r: int, points, counts) -> tuple:
    """triangulate at one halo round's shape: timed, held against its
    plain version, its trips split into parts by the kernel's clock64
    counters; returns the round's kernels-line row."""
    import numpy as np
    import torch
    from repro_torch.kernels.delaunay import ops as D
    from repro_torch.kernels.delaunay.ref import triangulate_ref

    pts = torch.as_tensor(np.asarray(points, np.float64), device=dev)
    cnt = torch.as_tensor(np.asarray(counts, np.int64), device=dev)
    B, N, dim = pts.shape
    C = D.cluster_size(B, N, dim, dev)
    kw = dict(dim=dim, num_simplices=D.simplex_capacity(N, dim), cavity=D.cavity_capacity(dim),
              group=D.group_size(dim))
    work = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    out, ms = sync_time(lambda: D.triangulate(pts, cnt, work=work, **kw), reps=1)
    parts = torch.zeros((B, len(D.TRIP_PARTS)), dtype=torch.int64, device=dev)
    D.triangulate(pts, cnt, parts=parts, **kw)
    # the plain version once, at the same shape: its result is the check
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wp = torch.zeros_like(work)
    start.record()
    ref = triangulate_ref(pts, cnt, work=wp, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    require(bool(ref[2].all()), f"halo round {r} of the 2-D plan holds a row that is not ok")
    for a, b, name in zip(out, ref, ("simp", "alive", "ok")):
        errs.same("triangulate", a, b, f"triangulate {name} at halo round {r}")
    errs.same("triangulate", work, wp, f"triangulate trips at halo round {r}")
    trips, scanned = (int(x) for x in work.sum(dim=0))
    longest = int(work[:, 0].max())
    # one in-sphere test per live slot and candidate: a d-term fma dot (2d
    # operations), the doubling, two adds and a compare
    tests = scanned * D.group_size(dim)
    in_bytes = pts.numel() * 8 + cnt.numel() * 8
    out_bytes = out[0].numel() * 4 + out[1].numel() + out[2].numel()
    bytes_s, ops_s = bound_terms(cost().triangulate(in_bytes, out_bytes, scanned,
                                                    D.group_size(dim), dim))
    # the trip's parts: clock64 cycles summed over rows and trips
    cyc = parts.sum(dim=0).double()
    share = cyc / cyc.sum()
    trip_us = ms * 1e3 / longest
    rec_bytes = (4 if dim == 2 else 6) * 8
    scan_bytes = scanned * rec_bytes / trips
    scan_us = trip_us * float(share[1])
    print(f"  triangulate halo round {r}: [{B}, {N}] {dim}-D rows (counts "
          f"{int(cnt.min())}..{int(cnt.max())}), S = {kw['num_simplices']}, clusters of {C} CTAs "
          f"({B * C} CTAs); {trips} trips ({longest} in the longest row), {scanned} live slots "
          f"scanned, {tests} in-sphere tests; kernel {ms:.3f} ms ({trip_us:.3f} us a trip), "
          f"plain {plain_ms:.3f} ms, bound {max(bytes_s, ops_s) * 1e3:.3f} ms "
          f"({'bytes' if bytes_s >= ops_s else 'operations'})")
    print(f"    trip parts (cycles a trip, share, us a trip): " + ", ".join(
        f"{name} {float(c) / trips:.0f} {float(f):.3f} {trip_us * float(f):.3f}"
        for name, c, f in zip(D.TRIP_PARTS, cyc, share)))
    print(f"    the scan reads {scan_bytes / 1e6:.3f} MB of live slot records a trip "
          f"({rec_bytes}-byte records): {scan_bytes / (scan_us * 1e-6) / 1e9:.1f} GB/s over its "
          f"share of the trip")
    # one call (reps=1): the back-to-back time is the call's own
    return ("triangulate", "src/repro_torch/kernels/delaunay/csrc/delaunay.cu",
            "src/repro/kernels/delaunay/delaunay.py:39", ms, ms, plain_ms, bytes_s, ops_s, None)


def rdg_timing(dev, rdgs: dict, errs: Errors) -> list:
    """Phase 4, Delaunay kernels at the 2-D RDG run's halo rounds."""
    import torch
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.delaunay import ops as D
    from repro_torch.kernels.delaunay.predicates import circumsphere
    from repro_torch.kernels.geom import ops as G
    from repro_torch.kernels.geom.ref import pair_edges_ref

    rows = []
    for r, (points, counts) in enumerate(rdgs["triangulate"]):
        row = dt_round_timing(dev, errs, r, points, counts)
        if r == 0:
            rows.append(row)
    torch.cuda.empty_cache()

    simp = rdgs["circumspheres"]
    (ca, ra, na), ms, med = timed(lambda: D.circumspheres(simp), reps=10, label="circumspheres")
    (cb, rb, nb), plain_ms = sync_time(lambda: circumsphere(simp, fused=False), reps=3)
    for a, b, name in ((ca, cb, "center"), (ra, rb, "r2"), (na, nb, "nondeg")):
        errs.same("circumspheres", a, b, f"circumspheres {name} at the certification batch")
    R, d1, d = simp.shape
    # read each simplex once, write center, r2 and the flag; the
    # determinants and the division are about 20 d^2 operations a simplex
    rows.append(("circumspheres", "src/repro_torch/kernels/delaunay/csrc/delaunay.cu",
                 "src/repro/core/rdg.py:99", ms, med, plain_ms,
                 *bound_terms(cost().circumspheres(R, d)), None))
    print(f"  circumspheres shape: the first round's certification batch, {R} simplices "
          f"[{d1}, {d}]")

    plan = rdgs["cert_plan"]
    full = [t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev)]
    kwp = dict(capacity=plan.capacity, dim=plan.dim, kinds=plan.kinds_present)
    (ea, ka), ms, med = timed(lambda: G.pair_edges(*full, **kwp), reps=10,
                              label="pair_edges, CERT rows")
    (eb, kb), plain_ms = sync_time(lambda: pair_edges_ref(*full, **kwp), reps=1)
    errs.same("pair_edges", ea, eb, "pair_edges CERT edges on the RDG 2-D plan")
    errs.same("pair_edges", ka, kb, "pair_edges CERT keep on the RDG 2-D plan")
    R = full[0].shape[0]
    slots = ka.numel()
    in_bytes = sum(t.numel() * t.element_size() for t in full)
    # not a row of the kernels line (pair_edges has its RHG row): printed
    bound = max(bound_terms(cost().pair_edges(in_bytes, R, plan.capacity, 0))) * 1e3
    print(f"  pair_edges on GEOM_CERT rows: the RDG 2-D plan, {R} rows x 16 slots, "
          f"{int(ka.sum())} edges kept; kernel median {med:.4f} ms (mean {ms:.4f}), plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes): {100 * bound / med:.1f} % of it")
    return rows


# ---------------------------------------------------------------- families --

def phase_family_kernels(dev, errs: Errors) -> None:
    """Phase 1, families: chunk_rmat and chunk_ba on mixed chunk rows of
    every kind (log_n 1, 26, 40; d 1 and 8; counts 0 up to capacity; a
    fresh output and one whose other rows stay), close_wedges on tables
    with all-sentinel rows, S up to 1024, NB up to 40000, unions within
    the filter's 32 bits a key and past it, chunk (prefix) and batched
    pair (mask) buffers, against both plain versions."""
    import torch
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import chunk_ba_ref, chunk_rmat_ref
    from repro_torch.kernels.wedges import ops as W
    from repro_torch.kernels.wedges.ref import close_wedges_ref, close_wedges_table_ref
    from repro_torch.kernels.wedges.table import FILTER_LOG_BITS
    from torch_family_rows import chunk_rows, wedge_inputs

    def both(name, got, want, what):
        errs.same(name, got[0], want[0], what + " edges")
        errs.same(name, got[1], want[1], what + " keep")

    R, cap = 512, 2048
    for log_n in (1, 26, 40):
        key, kind, params, fparams, count, owned = chunk_rows(R, cap, 8, log_n, dev)
        both("chunk_rmat", S.chunk_rmat(key, kind, params, fparams, count, owned, log_n, cap),
             chunk_rmat_ref(key, kind, params, fparams, count, owned, log_n, cap),
             f"chunk_rmat log_n={log_n}")
        out = (torch.full((R, cap, 2), -3, dtype=torch.int64, device=dev),
               torch.ones((R, cap), dtype=torch.bool, device=dev))
        ref = (out[0].clone(), out[1].clone())
        both("chunk_rmat", S.chunk_rmat(key, kind, params, fparams, count, owned, log_n, cap, out),
             chunk_rmat_ref(key, kind, params, fparams, count, owned, log_n, cap, ref),
             f"chunk_rmat log_n={log_n} into out")
    for d in (1, 8):
        key, kind, params, _, count, owned = chunk_rows(R, cap, d, 100 + d, dev)
        st, st_ref = (torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(2))
        both("chunk_ba", S.chunk_ba(key, kind, params, count, owned, cap, steps=st),
             chunk_ba_ref(key, kind, params, count, owned, cap, steps=st_ref), f"chunk_ba d={d}")
        # the steps walked equal the plain version's; the steps issued follow
        # the warps' schedule, which it does not model
        require(int(st[0]) == int(st_ref[0]) > 0 and int(st[0]) <= int(st[1])
                and int(st[1]) % 32 == 0, f"chunk_ba d={d}: chain steps (walked, issued) "
                f"{st.tolist()}, plain walked {int(st_ref[0])}")
        out = (torch.full((R, cap, 2), -3, dtype=torch.int64, device=dev),
               torch.ones((R, cap), dtype=torch.bool, device=dev))
        ref = (out[0].clone(), out[1].clone())
        both("chunk_ba", S.chunk_ba(key, kind, params, count, owned, cap, out),
             chunk_ba_ref(key, kind, params, count, owned, cap, ref), f"chunk_ba d={d} into out")
    cases = ((1, 1, 4096, 0), (65, 40, 200_000, 8), (200, 16, 100_000, 0),
             (1024, 64, 100_000, 0), (64, 8192, 400_000, 0), (64, 8192, 400_000, 64),
             (3, 40_000, 100_000, 0))
    unions = []
    for Sn, NB, N, batch in cases:
        edges, mask, nb = wedge_inputs(Sn, NB, N, Sn + NB, dev, batch=batch)
        flat, fmask = edges.reshape(-1, 2), mask.reshape(-1)
        table = W.wedge_table(nb)
        unions.append(table.union)
        what = f"close_wedges S={Sn} NB={NB} (union {table.union})"
        got = W.close_wedges(flat, table, mask=fmask)
        errs.same("close_wedges", got, close_wedges_ref(flat, nb, mask=fmask), what + " mask")
        errs.same("close_wedges", got, close_wedges_table_ref(flat, table, mask=fmask),
                  what + " mask, against the table's plain version")
        for k in (0, N // 3, N):
            got = W.close_wedges(flat, table, count=k)
            errs.same("close_wedges", got, close_wedges_ref(flat, nb, count=k),
                      f"{what} count={k}")
            errs.same("close_wedges", got, close_wedges_table_ref(flat, table, count=k),
                      f"{what} count={k}, against the table's plain version")
        empty = W.wedge_table(torch.full_like(nb, 1 << 62))
        require(not bool(W.close_wedges(flat, empty, mask=fmask).any()),
                "close_wedges: an all-sentinel table counted a wedge")
    require(max(unions) > (1 << FILTER_LOG_BITS[1]) // 32,
            "close_wedges: no phase 1 union past the filter's size")
    print(f"  families kernels == plain: chunk_rmat, chunk_ba on {R} mixed rows of capacity {cap}; "
          f"close_wedges on {len(cases)} tables (unions of {unions} vertices), against both "
          f"plain versions")


def family_spec(api, e):
    p = e["params"]
    return getattr(api, e["family"])(**(dict(p, probs=tuple(p["probs"])) if "probs" in p else p))


def phase_golden_families(dev) -> None:
    """Phase 2, families: the BA, R-MAT and SBM edge digests and the
    sampled clustering reports of families.json, recomputed on the card."""
    from repro_torch import api

    doc = json.loads((ROOT / "src" / "repro_torch" / "golden" / "families.json").read_text())
    for e in doc["generate"]:
        edges = api.generate(family_spec(api, e), e["P"], device=dev).edges
        require(len(edges) == e["m"] and sha256_edges(edges) == e["sha256"],
                f"golden generate {e['family']} {e['params']} P={e['P']}")
    for e in doc["clustering"]:
        rep = api.collect(family_spec(api, e), e["P"], device=dev,
                          metrics=("degree", "clustering"))
        require(rep.num_edges == e["num_edges"], f"golden clustering {e['family']}: edges")
        for f in CLUSTER_FIELDS:
            require([int(x) for x in getattr(rep.clustering, f)] == e[f],
                    f"golden clustering {e['family']} {e['params']}: {f} differs")
    print(f"  golden families: {len(doc['generate'])} edge digests, {len(doc['clustering'])} "
          f"clustering reports equal")


CLUSTER_FIELDS = ("sample", "degree", "triangles", "wedges", "valid")


def big_checksum(e, rows: int = 1 << 26) -> int:
    """:func:`edge_checksum` of a large edge list, a slice at a time."""
    return sum(edge_checksum(e[i:i + rows]) for i in range(0, len(e), rows)) % (1 << 64)


def stream_checksum(spec, P: int, dev, **kw):
    """(edges, waves, order-free checksum) of ``iter_edge_chunks``."""
    from repro_torch import api
    total = waves = c = 0
    for ch in api.iter_edge_chunks(spec, P, device=dev, **kw):
        ce = ch.edges()
        total += len(ce)
        c = (c + big_checksum(ce)) % (1 << 64)
        waves += 1
    return total, waves, c


def capture_wedges(store: dict):
    """Wrap ``ClusteringSampler.count_triangles_chunk`` to keep, per kind
    of buffer, the inputs of its call with the most valid slots (phase 4
    times close_wedges there), and time each sampler's build of its
    wedge table (``store["builds"]``: seconds, table).  Returns the undo."""
    import torch
    from repro_torch.stats.accumulate import ClusteringSampler

    real, real_table = ClusteringSampler.count_triangles_chunk, ClusteringSampler._wedge_table

    def wrapped(self, buffer, count=None, mask=None, row=0):
        form = "mask" if mask is not None else "prefix"
        valid = int(mask.sum()) if mask is not None else int(count)
        if valid > store.get(form, (0,))[0] and self.neighbors is not None:
            store[form] = (valid, buffer.reshape(-1, 2),
                           None if mask is None else mask.reshape(-1), count,
                           self._neighbor_table().to(buffer.device),
                           self._wedge_table(buffer.device))
        return real(self, buffer, count=count, mask=mask, row=row)

    def timed_table(self, card):
        if self._table is None:
            t0 = time.perf_counter()
            table = real_table(self, card)
            torch.cuda.synchronize()
            store.setdefault("builds", []).append((time.perf_counter() - t0, table))
        return real_table(self, card)

    ClusteringSampler.count_triangles_chunk = wrapped
    ClusteringSampler._wedge_table = timed_table

    def undo():
        ClusteringSampler.count_triangles_chunk = real
        ClusteringSampler._wedge_table = real_table
    return undo


def table_line(build) -> str:
    secs, t = build
    return (f"wedge table built in {secs:.6f}s: union {t.union} vertices, {t.ids.numel()} "
            f"sample entries, {t.hkey.numel()} slots, filter 2^{t.log_f} bits, "
            f"{t.nbytes()} bytes")


def recount_triangles(e, sample, cap: int):
    """Each sampled vertex's triangles recomputed from the whole edge list
    ``e`` (its neighbour table built from ``e``, then the plain wedge
    count over slices), independent of the sampler."""
    import torch
    from repro_torch.kernels.wedges.ref import close_wedges_ref

    rows = []
    for s in sample.tolist():
        nb = torch.cat([e[e[:, 0] == s, 1], e[e[:, 1] == s, 0]]).unique()
        rows.append(nb if len(nb) <= cap else nb[:0])
    width = max(1, max(len(r) for r in rows))
    tbl = torch.full((len(rows), width), 1 << 62, dtype=torch.int64, device=e.device)
    for i, r in enumerate(rows):
        tbl[i, : len(r)] = r
    step = max(1, (1 << 28) // max(1, len(rows)))
    tri = sum(close_wedges_ref(e[i:i + step], tbl) for i in range(0, len(e), step))
    return tri.cpu().numpy()


def phase_families(dev, sizes: dict) -> dict:
    """Phase 3d: R-MAT, BA and SBM at full width, and the sampled
    clustering collects of RHG (pair path) and SBM (chunk path)."""
    import numpy as np
    import torch
    from repro_torch import api

    log_n, m = sizes["rmat_log_n"], sizes["rmat_m"]
    rspec = api.RMAT(log_n=log_n, m=m, probs=(0.57, 0.19, 0.19, 0.05), seed=8)
    rplan = rspec.plan(1)
    torch.cuda.reset_peak_memory_stats(dev)
    g, groups, wall = profiled(lambda: api.generate(rspec, 1, device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    e = g.edges
    require(g.m == m, f"RMAT: {g.m} edges, want {m}")
    top = log_n - 1
    a_b = float(((e[:, 0] >> top) == 0).double().mean())     # quadrants a, b: source top bit 0
    a_c = float(((e[:, 1] >> top) == 0).double().mean())     # quadrants a, c
    require(abs(a_b / 0.76 - 1) < 0.005 and abs(a_c / 0.76 - 1) < 0.005,
            f"RMAT: top-bit shares {a_b:.6f}, {a_c:.6f}, want a+b = a+c = 0.76 within 0.5 %")
    require(int(e.max()) < 1 << log_n and int(e.min()) >= 0, "RMAT: a vertex out of range")
    chk = big_checksum(e)
    print(f"  generate RMAT(log_n={log_n}, m={m}) P=1: capacity {rplan.capacity}, wall "
          f"{wall:.3f}s, {m / wall:.4g} edges/s, peak device memory {peak / 2**30:.3f} GiB; "
          f"top-bit shares a+b {a_b:.6f}, a+c {a_c:.6f} (want 0.76)")
    print_breakdown("RMAT generate", groups, wall)
    del g, e
    torch.cuda.empty_cache()
    (total, waves, c), groups, swall = profiled(lambda: stream_checksum(rspec, 16, dev))
    require(total == m and c == chk, "RMAT: the stream at P=16 differs from generate at P=1")
    print(f"  stream RMAT P=16: {waves} chunks, {total} edges, the same checksum, {swall:.3f}s, "
          f"{total / swall:.4g} edges/s")
    print_breakdown("RMAT stream", groups, swall)

    n, d = sizes["ba_n"], 8
    bspec = api.BA(n=n, d=d, seed=9)
    torch.cuda.reset_peak_memory_stats(dev)
    g, groups, wall = profiled(lambda: api.generate(bspec, 1, device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    e = g.edges
    require(g.m == n * d, f"BA: {g.m} edges, want n d = {n * d}")
    require(bool((e[:, 0] == torch.arange(n * d, device=dev) // d).all()),
            "BA: sources are not e // d in edge order")
    require(bool((e[:, 1] <= e[:, 0]).all()), "BA: a target after its source")
    chk = big_checksum(e)
    indeg = torch.bincount(e[:, 1], minlength=n)
    print(f"  generate BA(n={n}, d={d}) P=1: {g.m} edges, wall {wall:.3f}s, {g.m / wall:.4g} "
          f"edges/s, peak device memory {peak / 2**30:.3f} GiB, largest in-degree "
          f"{int(indeg.max())}")
    print_breakdown("BA generate", groups, wall)
    del g, e, indeg
    torch.cuda.empty_cache()
    (total, waves, c), groups, swall = profiled(lambda: stream_checksum(bspec, 16, dev))
    require(total == n * d and c == chk, "BA: the stream at P=16 differs from generate at P=1")
    print(f"  stream BA P=16: {waves} chunks, {total} edges, the same checksum, {swall:.3f}s")
    print_breakdown("BA stream", groups, swall)

    sn, B = sizes["sbm_n"], sizes["sbm_blocks"]
    p_in, p_out = sizes["sbm_p"]
    sspec = api.SBM(n=sn, blocks=B, p_in=p_in, p_out=p_out, seed=10)
    t0 = time.perf_counter()
    splan = sspec.plan(1)
    plan_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    (g, seen), groups, wall = profiled(lambda: sampler_rounds(
        lambda: api.generate(sspec, 1, device=dev)))
    peak = torch.cuda.max_memory_allocated(dev)
    e = g.edges
    require(g.m == splan.total_edges, f"SBM: {g.m} edges, plan says {splan.total_edges}")
    require(bool((e[:, 0] > e[:, 1]).all()), "SBM: an edge without u > v (or a self loop)")
    require(no_duplicates(e[:, 0] * sn + e[:, 1]), "SBM: duplicate edges")
    w = sn // B
    region = torch.bincount((e[:, 0] // w) * B + e[:, 1] // w, minlength=B * B).cpu().numpy()
    region = region.reshape(B, B)
    worst = 0.0
    for i in range(B):
        for j in range(i + 1):
            pairs = w * (w - 1) // 2 if i == j else w * w
            dens = region[i, j] / pairs / (p_in if i == j else p_out)
            worst = max(worst, abs(dens - 1))
    require(worst < 0.02 and region[np.triu_indices(B, 1)].sum() == 0,
            f"SBM: a block density {worst:.4f} off its p, or an edge above the diagonal")
    chk = big_checksum(e)
    sdeg = torch.bincount(e.reshape(-1), minlength=sn)
    print(f"  generate SBM(n={sn}, blocks={B}) P=1: {splan.chunks_per_pe} regions, capacity "
          f"{splan.capacity}, {round_summary(seen)}, {g.m} edges, worst block density off by "
          f"{worst:.5f}, wall "
          f"{wall:.3f}s (host plan {plan_s:.3f}s), {g.m / wall:.4g} edges/s, peak device "
          f"memory {peak / 2**30:.3f} GiB")
    print_breakdown("SBM generate", groups, wall)
    s_edges = e
    del g
    (total, waves, c), groups, swall = profiled(lambda: stream_checksum(sspec, 16, dev))
    require(total == len(s_edges) and c == chk, "SBM: the stream at P=16 differs from P=1")
    print(f"  stream SBM P=16: {waves} chunks, {total} edges, the same checksum, {swall:.3f}s")
    print_breakdown("SBM stream", groups, swall)

    wedges: dict = {}
    undo = capture_wedges(wedges)
    try:
        hspec = api.RHG(n=sizes["rhg_n"], avg_deg=16.0, gamma=2.8, seed=5)
        hkw = {"metrics": ("degree", "clustering"), "batch": sizes["batch"]}
        (rep, hl, nc), groups, cwall = profiled(lambda: counted_collect(hspec, 16, dev, **hkw))
        ONE_DEVICE_REPORTS[report_key(hspec, 16, hkw)] = rep
        h1 = api.collect(hspec, 1, device=dev, batch=sizes["batch"],
                         metrics=("degree", "clustering"))
        cc = rep.clustering
        for f in CLUSTER_FIELDS:
            require(np.array_equal(getattr(cc, f), getattr(h1.clustering, f)),
                    f"clustering RHG: {f} at P=16 differs from P=1")
        require(np.array_equal(cc.degree, h1.degree.degrees[torch.from_numpy(cc.sample).to(dev)]
                               .cpu().numpy()), "clustering RHG: sample degrees off")
        print(f"  collect RHG(n={sizes['rhg_n']}) P=16 with clustering: {len(cc.sample)} samples, "
              f"{int(cc.valid.sum())} valid, global cc {cc.global_cc:.6f}, mean local cc "
              f"{cc.mean_local_cc:.6f}, {cwall:.3f}s; {hl} hist launches for {nc} non-empty "
              f"waves; the same report at P=1")
        print_breakdown("RHG clustering collect", groups, cwall)
        print(f"  RHG clustering collect P=16, {table_line(wedges['builds'][0])}")
        (rep, hl, nc), groups, cwall = profiled(lambda: counted_collect(
            sspec, 1, dev, metrics=("degree", "clustering")))
    finally:
        undo()
    cc = rep.clustering
    require(rep.num_edges == len(s_edges), "clustering SBM: edge count differs from generate")
    require(np.array_equal(cc.degree, sdeg[torch.from_numpy(cc.sample).to(dev)].cpu().numpy()),
            "clustering SBM: sample degrees differ from the generated edges'")
    want = recount_triangles(s_edges, cc.sample, 8192)
    require(np.array_equal(cc.triangles, want), "clustering SBM: triangles differ from a "
            "recount over the generated edges")
    print(f"  collect SBM P=1 with clustering: {len(cc.sample)} samples, {int(cc.valid.sum())} "
          f"valid, {int(cc.triangles.sum())} triangles (= a recount over the generated edges), "
          f"global cc {cc.global_cc:.6f}, {cwall:.3f}s; {hl} hist launches for {nc} chunks")
    print_breakdown("SBM clustering collect", groups, cwall)
    print(f"  SBM clustering collect, {table_line(wedges['builds'][-1])}")
    del s_edges, sdeg
    torch.cuda.empty_cache()
    return {"rmat_plan": rplan, "ba_plan": bspec.plan(1), "sbm_plan": splan, "wedges": wedges}


def families_timing(dev, fam: dict, errs: Errors) -> list:
    """Phase 4, families: chunk_rmat and chunk_ba at their generate
    shapes (the plain versions on the first 2^22 slots: the whole shape
    does not fit), close_wedges at the largest buffer of each clustering
    collect (an SBM chunk, prefix form; an RHG wave, mask form)."""
    import torch
    from repro_torch.distrib.runtime import plan_tensors
    from repro_torch.kernels.sampler import ops as S
    from repro_torch.kernels.sampler.ref import chunk_ba_ref, chunk_rmat_ref
    from repro_torch.kernels.wedges import ops as W
    from repro_torch.kernels.wedges.ref import close_wedges_ref, close_wedges_table_ref
    from repro_torch.kernels.wedges.table import probe

    rows, sub = [], 1 << 22

    def tables(plan):
        kind, key, _, cnt, params, fparams, owned = (
            t.reshape(-1, *t.shape[2:]) for t in plan_tensors(plan, dev))
        return key, kind, params, fparams, cnt, owned

    plan = fam["rmat_plan"]
    key, kind, params, fparams, cnt, owned = tables(plan)
    cap, log_n = plan.capacity, plan.rmat_log_n
    slots = kind.numel() * cap
    out = (torch.empty((kind.numel(), cap, 2), dtype=torch.int64, device=dev),
           torch.empty((kind.numel(), cap), dtype=torch.bool, device=dev))
    _, ms, med = timed(lambda: S.chunk_rmat(key, kind, params, fparams, cnt, owned, log_n, cap,
                                            out), label=f"chunk_rmat [{kind.numel()}, {cap}]")
    del out
    torch.cuda.empty_cache()
    a = S.chunk_rmat(key, kind, params, fparams, cnt, owned, log_n, sub)
    b, plain_ms = sync_time(lambda: chunk_rmat_ref(key, kind, params, fparams, cnt, owned,
                                                   log_n, sub), reps=1)
    errs.same("chunk_rmat", a[0], b[0], "chunk_rmat on its first 2^22 slots")
    errs.same("chunk_rmat", a[1], b[1], "chunk_rmat keep on its first 2^22 slots")
    del a, b
    out_s, ops = bound_terms(cost().chunk_rmat(kind.numel(), cap, log_n))
    rows.append(("chunk_rmat", "src/repro_torch/kernels/sampler/csrc/sampler.cu",
                 "src/repro/distrib/engine.py:426", ms, med, plain_ms,
                 out_s, ops, None))
    print(f"  chunk_rmat: {slots} slots x {2 + log_n} Threefry blocks; bound {ops * 1e3:.3f} ms "
          f"(operations), {ms / (ops * 1e3):.2f}x; plain version {plain_ms:.3f} ms on the first "
          f"{sub} slots")
    torch.cuda.empty_cache()

    plan = fam["ba_plan"]
    key, kind, params, fparams, cnt, owned = tables(plan)
    cap = plan.capacity
    slots = kind.numel() * cap
    out = (torch.empty((kind.numel(), cap, 2), dtype=torch.int64, device=dev),
           torch.empty((kind.numel(), cap), dtype=torch.bool, device=dev))
    _, ms, med = timed(lambda: S.chunk_ba(key, kind, params, cnt, owned, cap, out),
                       label=f"chunk_ba [{kind.numel()}, {cap}]")
    steps = torch.zeros(2, dtype=torch.int64, device=dev)
    S.chunk_ba(key, kind, params, cnt, owned, cap, out, steps=steps)
    steps, issued = steps.tolist()
    del out
    torch.cuda.empty_cache()
    a = S.chunk_ba(key, kind, params, cnt, owned, sub)
    b, plain_ms = sync_time(lambda: chunk_ba_ref(key, kind, params, cnt, owned, sub), reps=1)
    errs.same("chunk_ba", a[0], b[0], "chunk_ba on its first 2^22 slots")
    errs.same("chunk_ba", a[1], b[1], "chunk_ba keep on its first 2^22 slots")
    del a, b
    # a step: fold_in64 (2 blocks), split (2), two 64-bit words (2); the
    # reciprocal and five remainders of a step are not counted, so this is
    # a lower bound
    out_s, ops = bound_terms(cost().chunk_ba(kind.numel(), cap, steps))
    rows.append(("chunk_ba", "src/repro_torch/kernels/sampler/csrc/sampler.cu",
                 "src/repro/distrib/engine.py:446", ms, med, plain_ms,
                 out_s, ops, None))
    print(f"  chunk_ba: {slots} slots, {steps} chain steps walked ({steps / slots:.4f} a slot) "
          f"x 6 Threefry blocks; the warps issued {issued} steps ({issued / steps:.4f}x the "
          f"walked: lanes refilled from each warp's batch); bound {ops * 1e3:.3f} ms (operations), "
          f"{ms / (ops * 1e3):.2f}x; plain version {plain_ms:.3f} ms on the first {sub} slots")
    torch.cuda.empty_cache()

    # the collision sampler at the largest SBM batch (printed; the kernels
    # line's entry is GNM generate's)
    _, vals = sampler_timing(dev, fam["sbm_plan"], errs, "SBM generate")
    del vals
    torch.cuda.empty_cache()

    for form, label in (("prefix", "SBM chunk"), ("mask", "RHG wave")):
        valid, flat, mask, count, nb, table = fam["wedges"][form]
        Sn, NB = nb.shape
        live = int((nb[:, 0] != 1 << 62).sum())
        kw = {"mask": mask} if mask is not None else {"count": count}
        # timed as the sampler calls it, adding into its counts
        acc = torch.zeros(Sn, dtype=torch.int64, device=dev)
        _, ms, med = timed(lambda: W.close_wedges(flat, table, out=acc, **kw), reps=10,
                           label=f"close_wedges {label}")
        dev_ms = graph_ms_per_call(lambda: W.close_wedges(flat, table, out=acc, **kw), 20)
        got = W.close_wedges(flat, table, **kw)
        want, plain_ms = sync_time(lambda: close_wedges_ref(flat, nb, **kw), reps=1)
        errs.same("close_wedges", got, want, f"close_wedges at the {label}")
        errs.same("close_wedges", got, close_wedges_table_ref(flat, table, **kw),
                  f"close_wedges at the {label}, against the table's plain version")
        # bytes: the mask (or nothing) once, each valid edge once, the
        # table once, the counts written once.  Operations, this run's
        # data: a probe of u a valid slot, a probe of v where u is in the
        # union, a merge step per entry of both lists where v is too; 8
        # integer operations a probe (the 64-bit multiply as 3, the shift,
        # the key's two-word compare and the empty test), 4 a merge step
        e = flat[mask] if mask is not None else flat[:count]
        su = probe(table, e[:, 0].contiguous())
        in_u = su >= 0
        sv = probe(table, e[in_u, 1].contiguous())
        both = sv >= 0
        a, b = su[in_u][both], sv[both]
        steps = int((table.off[a + 1] - table.off[a] + table.off[b + 1] - table.off[b]).sum())
        hits_u, hits_uv = int(in_u.sum()), int(both.sum())
        mask_bytes = flat.shape[0] if mask is not None else 0
        c = cost().close_wedges(mask_bytes, valid, table.nbytes(), Sn, hits_u, steps)
        nbytes = c.bytes
        bytes_s, ops = bound_terms(c)
        bound = max(bytes_s, ops)
        if form == "prefix":     # the kernels line's entry; the wave is printed only
            rows.append(("close_wedges", "src/repro_torch/kernels/wedges/csrc/wedges.cu",
                         "src/repro/stats/accumulate.py:42", ms, med, plain_ms,
                         bytes_s, ops, None))
        # PR 16's bound, for continuity: per live row and valid slot two
        # binary searches of ceil(log2(NB + 1)) + 1 steps of 4 operations,
        # and the [S, NB] table read once
        old_bound = max(bound_terms(cost().close_wedges_pr16(mask_bytes, valid, Sn, NB, live)))
        print(f"  close_wedges at the {label}: {flat.shape[0]} slots, {valid} valid, {Sn} samples "
              f"({live} live rows), neighbour table width {NB}, sum of row lengths "
              f"{table.ids.numel()}, union {table.union} vertices in {table.hkey.numel()} slots "
              f"(filter 2^{table.log_f} bits); u in the union {hits_u}, both "
              f"{hits_uv}, {steps} merge entries; median {med:.6f} ms (device {dev_ms:.6f} ms "
              f"by graph replay), bound "
              f"{bound * 1e3:.6f} ms ({'bytes' if bytes_s >= ops else 'operations'}"
              f": {nbytes} bytes, operations {ops * 1e3:.6f} ms), {100 * bound * 1e3 / med:.1f} % "
              f"of the median, {100 * bound * 1e3 / dev_ms:.1f} % of the device time; PR 16's "
              f"formula {old_bound * 1e3:.6f} ms; plain {plain_ms:.3f} ms")
    return rows


# kernels that no main path launches, and why
def report_fields(rep) -> dict:
    """A validation report as ``golden/stats.json`` stores it: each
    check's floats as hex, the report's text line by line."""
    def hx(x):
        return None if x is None else float(x).hex()
    return {"family": rep.family, "P": int(rep.P), "passed": bool(rep.passed),
            "num_edges": int(rep.stats.num_edges), "mode": rep.stats.mode,
            "checks": [{"name": c.name, "passed": bool(c.passed), "observed": hx(c.observed),
                        "expected": hx(c.expected), "pvalue": hx(c.pvalue), "detail": c.detail}
                       for c in rep.checks],
            "str": str(rep).splitlines()}


def phase_golden_stats(dev) -> None:
    """Phase 2, validation: the reference's ``validate`` reports of
    stats.json (its acceptance gates at n = 2^18 and its smoke families)
    recomputed on the card, every float64 and line equal."""
    from repro_torch import api

    doc = json.loads((ROOT / "src" / "repro_torch" / "golden" / "stats.json").read_text())
    for e in doc["validate"]:
        t0 = time.perf_counter()
        rep = api.validate(getattr(api, e["family"])(**e["params"]), e["P"], device=dev,
                           **e["kwargs"])
        got = report_fields(rep)
        for k, v in got.items():
            require(v == e[k], f"golden validate {e['family']} {e['params']} P={e['P']}: "
                               f"{k} differs: {v} against {e[k]}")
        print(f"  golden validate {e['family']} n={rep.stats.n} P={e['P']}: report equal "
              f"({len(rep.checks)} checks, {time.perf_counter() - t0:.3f}s)")
    print(f"  golden validate: {len(doc['validate'])} reports equal")


# gates of the chip-size validations that the reference's own law misses
# at that size, each with where ROADMAP §3 records it: (family, check) ->
# note.  Such a gate is printed, not required; the others are.
REFERENCE_FINDINGS: dict = {}


def validate_specs(api, sizes: dict) -> list:
    """(spec, P, collect kwargs) of the chip-size validations: the specs
    the other main paths run."""
    n_c, n_r, n_s = sizes["collect_n"], sizes["rhg_n"], sizes["sbm_n"]
    p_in, p_out = sizes["sbm_p"]
    return [(api.GNP(n=n_c, p=16 / n_c, seed=3), 1, {}),
            (api.GNM(n=sizes["gnm_n"], m=sizes["gnm_m"], seed=1), 1, {}),
            (api.RHG(n=n_r, avg_deg=16, gamma=2.8, seed=5), 16, {"batch": sizes["batch"]}),
            (api.RDG(n=sizes["rdg2_n"], dim=2, seed=6), 1, {"batch": sizes["batch"]}),
            (api.BA(n=sizes["ba_n"], d=8, seed=9), 16, {}),
            (api.RMAT(log_n=sizes["rmat_log_n"], m=sizes["rmat_m"], seed=8), 16, {}),
            (api.SBM(n=n_s, blocks=sizes["sbm_blocks"], p_in=p_in, p_out=p_out, seed=10),
             16, {})]


_POS = 0x9E3779B97F4A7C15 - (1 << 64)


def timed_stream(spec, P: int, dev, overlap: int, batch: int):
    """One run of ``iter_edge_chunks``: (edges, chunks, order-free
    checksum, per-PE digests, s to the first chunk's edges, wall s).  A
    PE's digest mixes each edge with its position in that PE's stream, so
    it holds the regrouped per-PE order."""
    import torch
    from repro_torch import api

    digests = Digests()
    total = chunks = c = 0
    first = None
    t0 = time.perf_counter()
    for ch in api.iter_edge_chunks(spec, P, device=dev, overlap=overlap, batch=batch):
        e = ch.edges()
        if first is None:
            first = time.perf_counter() - t0
        total, chunks = total + len(e), chunks + 1
        c = (c + big_checksum(e)) % (1 << 64)
        digests.add(ch.pe, e)
    torch.cuda.synchronize(dev)
    return (total, chunks, c, tuple(digests.of(pe) for pe in range(P)), first,
            time.perf_counter() - t0)


def overlap_turns(spec, P: int, dev, batch: int, cold, turns=(0, 4, 4, 0)) -> list:
    """The stream of ``spec`` with the overlaps of ``turns`` in turns, each under
    the profiler and traced by ``obs`` (the consumer's wait on the planner
    is the sum of its ``plan/overlap/wait`` spans; tracing ends each wave
    in a synchronize); ``cold()`` runs before each.  Requires every run to
    give the same checksum and per-PE digests; returns ``(overlap, edges,
    checksum, digests)`` of each run."""
    from repro_torch import obs

    runs = []
    for overlap in turns:
        cold()
        with obs.capture() as tr:
            out, groups, wall = profiled(lambda: timed_stream(spec, P, dev, overlap, batch))
        total, chunks, c, digests, first, _ = out
        wait = sum(r.seconds for r in tr.spans() if r.name == "plan/overlap/wait")
        runs.append((overlap, total, c, digests))
        print(f"  stream {spec} P={P} overlap={overlap}: {chunks} chunks, {total} edges, "
              f"checksum {c:#018x}, first chunk {first:.6f}s, wall {wall:.6f}s, "
              f"planner wait {wait:.6f}s (plan/overlap/wait spans); phases "
              + ", ".join(f"{k} {v:.6f}" for k, v in tr.phase_totals().items()))
        print_breakdown(f"overlap={overlap}", groups, wall)
    for overlap, *got in runs[1:]:
        require(tuple(got) == runs[0][1:],
                f"{spec} P={P}: the overlap={overlap} stream differs from the unsegmented "
                f"one (edges, checksum or per-PE order)")
    return runs


def validate_checks(rep, P: int, groups: dict, wall: float) -> None:
    """Print a chip-size report in full and require every gate (a finite
    ``observed``, and a pass unless the gate is a known reference finding)."""
    import math

    print("\n".join("    " + ln for ln in str(rep).splitlines()))
    print_breakdown(f"validate {rep.family}", groups, wall)
    for c in rep.checks:
        require(math.isfinite(c.observed), f"validate {rep.family}: {c.name} not finite")
        note = REFERENCE_FINDINGS.get((rep.family, c.name))
        if note:
            print(f"    {c.name}: {'PASS' if c.passed else 'FAIL'}, a known reference "
                  f"finding ({note})")
        else:
            require(c.passed, f"validate {rep.family} P={P}: gate {c.name} failed")


def phase_stats(dev, sizes: dict) -> dict:
    """Phase 3e: ``validate`` at the chip sizes, then plan/execute overlap
    (SBM's native segments; RDG's cold seed, triangulated on the planner
    thread) against the unsegmented streams."""
    import importlib
    import threading
    import torch
    from repro_torch import api
    from repro_torch.core import rdg

    # the module: the package's name ``validate`` is the function
    vmod = importlib.import_module("repro_torch.stats.validate")
    real_collect, collect_s = vmod.collect, []

    def timed_collect(*a, **k):
        t = time.perf_counter()
        out = real_collect(*a, **k)
        torch.cuda.synchronize(dev)
        collect_s.append(time.perf_counter() - t)
        return out

    vmod.collect = timed_collect
    try:
        for spec, P, kw in validate_specs(api, sizes):
            rep, groups, wall = profiled(lambda: api.validate(spec, P, device=dev, **kw))
            print(f"  validate {spec} P={P}: {wall:.3f}s, of which collect {collect_s[-1]:.3f}s "
                  f"and the model and gates {wall - collect_s[-1]:.3f}s")
            validate_checks(rep, P, groups, wall)
    finally:
        vmod.collect = real_collect
    rdg.rdg_structure.cache_clear()

    p_in, p_out = sizes["sbm_p"]
    sbm = api.SBM(n=sizes["sbm_n"], blocks=sizes["sbm_blocks"], p_in=p_in, p_out=p_out,
                  seed=10)
    overlap_turns(sbm, 16, dev, 1, lambda: None)

    # a cold seed: every run plans from nothing, so the overlapped runs
    # triangulate on the planner thread
    real_dt, threads = rdg.batched_delaunay, []

    def traced_dt(*a, **k):
        threads[-1].append(threading.current_thread().name)
        return real_dt(*a, **k)

    def cold():
        if rdg.rdg_structure.cache_info().currsize:     # the last run's structure
            rdg.rdg_structure(sizes["overlap_rdg_n"], 16, 2, "threefry2x32", 0, 8).clear_columns()
        rdg.rdg_structure.cache_clear()
        threads.append([])

    rdg_spec = api.RDG(n=sizes["overlap_rdg_n"], dim=2, seed=16)
    rdg.batched_delaunay = traced_dt
    try:
        rdg_runs = overlap_turns(rdg_spec, 16, dev, sizes["batch"], cold, turns=(0, 4))
    finally:
        rdg.batched_delaunay = real_dt
        rdg.rdg_structure.cache_clear()
    print(f"  RDG triangulate calls by thread, run by run: {threads}")
    for (overlap, *_), names in zip(rdg_runs, threads):
        want = "repro-torch-plan-emitter" if overlap else threading.main_thread().name
        require(set(names) == {want},
                f"RDG overlap={overlap}: triangulate ran on {names}, want {want}")
    torch.cuda.empty_cache()
    return {}


def stats_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of path 3e: none.  Its kernels are timed on the paths
    whose shapes they run at; its walls are printed by the path."""
    return []


# ------------------------------------------------------------------ serve --

def serve_fleet(api, sizes: dict) -> tuple:
    """The fleet of path 3f: ``(spec, sink)`` of 40 requests, each with its
    own seed, the first request of each family with the graph sink; and
    the 6 admitted mid-drain, one a family, with new seeds."""
    n, m = sizes["serve_n"], sizes["serve_m"]
    make = [("GNM", 8, lambda s: api.GNM(n=n, m=m, seed=s)),
            ("GNP", 8, lambda s: api.GNP(n=n, p=16 / n, seed=s)),
            ("BA", 8, lambda s: api.BA(n=n, d=16, seed=s)),
            ("SBM", 8, lambda s: api.SBM(n=n, blocks=16, p_in=2.0 ** -15, p_out=2.0 ** -19,
                                         seed=s)),
            ("RMAT", 4, lambda s: api.RMAT(log_n=n.bit_length() - 1, m=m, seed=s)),
            ("RHG", 4, lambda s: api.RHG(n=sizes["serve_rhg_n"], avg_deg=16, gamma=2.8,
                                         seed=s))]
    fleet, seed = [], 100
    for _, count, f in make:
        for i in range(count):
            fleet.append((f(seed), "graph" if i == 0 else "stats"))
            seed += 1
    late = [(f(seed + k), "stats") for k, (_, _, f) in enumerate(make)]
    return fleet, late


def peek_groups(scheduler) -> list:
    """``(program, valid, rows)`` of the next slab of every packing group,
    as ``tick`` would run it (``peek_slab`` takes the group the round
    robin is at, so the round robin is stepped over each and put back)."""
    rr, out = scheduler._rr, []
    try:
        for i in range(sum(bool(g.queue) for g in scheduler._groups.values())):
            scheduler._rr = i
            out.append(scheduler.peek_slab())
    finally:
        scheduler._rr = rr
    return out


def serve_run(dev, sizes: dict, label: str, check_syncs: bool = False, peek=None):
    """One run of the fleet on a fresh ``Service(P=16, slab_batch=16,
    slab_bytes=sizes["serve_slab_bytes"])``: every request submitted at
    once, 6 more (one a family, plan-cache hits) after 8 ticks, then
    drained.  Returns the service, the tickets with their specs, the wall
    s and the implicit host syncs (counted through the sync debug mode
    when ``check_syncs``).  ``peek``, a list, receives the first slab of
    every packing group (outside the wall)."""
    import warnings
    import torch
    from repro_torch import api
    from repro_torch.serve import Service

    fleet, late = serve_fleet(api, sizes)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    syncs = None
    with warnings.catch_warnings(record=True) as caught:
        if check_syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            svc = Service(16, device=dev, slab_batch=16, slab_bytes=sizes["serve_slab_bytes"])
            tickets = [(spec, svc.submit(spec, sink=sink)) for spec, sink in fleet]
            if peek is not None:
                t1 = time.perf_counter()
                peek += peek_groups(svc.scheduler)
                t0 += time.perf_counter() - t1
            for _ in range(8):
                svc.tick()
            before = svc.cache.stats["hits"]
            tickets += [(spec, svc.submit(spec, sink=sink)) for spec, sink in late]
            require(svc.cache.stats["hits"] == before + len(late),
                    "serve: a mid-drain admission missed the plan cache")
            svc.drain()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if check_syncs:
        syncs = sum("synchroniz" in str(w.message) for w in caught)
    peak = torch.cuda.max_memory_allocated(dev)
    st = svc.stats
    fill = svc.scheduler._m_fill
    groups = svc.scheduler._groups.values()
    slab_bytes = max(svc.scheduler.D * g.B * g.program.slot_bytes for g in groups)
    widths = ", ".join(f"{g.program.plan_kind} class {g.program.capacity}: {g.B}"
                       for g in groups)
    print(f"  serve {label}: {len(tickets)} requests, wall {wall:.6f}s, "
          f"{len(tickets) / wall:.4f} requests/s, ticket latency p50 "
          f"{svc.latency_percentile(0.5):.6f}s p99 {svc.latency_percentile(0.99):.6f}s, "
          f"{st['slabs']} slabs, {st['slots']} slots, mean slab fill "
          f"{fill.sum / fill.count:.4f}, cache hits {st['cache']['hits']} misses "
          f"{st['cache']['misses']}, packing groups {len(svc.scheduler._groups)} (slots a "
          f"slab: {widths}), largest slab {slab_bytes / 2**30:.3f} GiB of output, peak device "
          f"memory {peak / 2**30:.3f} GiB")
    if syncs is not None:
        print(f"  serve {label} host syncs: {syncs} implicit (sync debug mode: extractions of "
              f"the graph sinks) + {svc.syncs} ticket stamps = "
              f"{(syncs + svc.syncs) / st['slabs']:.4f} a slab")
    return svc, tickets, wall


def serve_compare(dev, tickets) -> float:
    """Every served request against ``generate(spec, 16)`` on the card, one
    at a time: the graph sinks edge for edge, the stats sinks by edge count
    and degree array.  Returns the naive loop's wall: the generate calls
    alone, each ending in a synchronize."""
    import torch
    from repro_torch import api

    naive = 0.0
    for spec, t in tickets:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        g = api.generate(spec, 16, device=dev)
        torch.cuda.synchronize(dev)
        naive += time.perf_counter() - t0
        got = t.result()
        if isinstance(got, dict):
            require(got["num_edges"] == g.m and torch.equal(got["degrees"], g.degrees()),
                    f"serve: {spec} stats differ from generate's")
        else:
            require(torch.equal(got.edges, g.edges), f"serve: {spec} edges differ from generate's")
        del g, got
    return naive


def phase_serve(dev, sizes: dict) -> dict:
    """Phase 3f: the serving tier on the card.  The fleet (40 requests of
    six families, 6 more admitted mid-drain), every request against
    ``generate``; the naive loop; the fleet again under the profiler and
    traced; an overlapped SBM chunk stream; RDG cold and reseeded; fault
    reissue on 4 slab rows; a pair plan past the staging limit that
    ``pair_edges`` had by capacity; each family's cold plan against its
    reseed.  Returns the first slab of each of the fleet's packing groups
    and of the class-8192 RGG, which phase 4 holds against the plain
    versions."""
    import math
    import torch
    from repro_torch import api, obs
    from repro_torch.core import rdg, rgg
    from repro_torch.kernels import build
    from repro_torch.serve import Service, program_of

    t_path = time.perf_counter()

    def step(what: str) -> None:
        print(f"  [3f {what}: {time.perf_counter() - t_path:.3f}s into the path]", flush=True)

    before = dict(build.LAUNCHES)
    slabs = []
    svc, tickets, wall = serve_run(dev, sizes, "fleet (cold cache)", check_syncs=True,
                                   peek=slabs)
    served = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
    print(f"  serve fleet launches: {served}")
    for name in ("hist", "chunk_sample", "chunk_decode", "chunk_ba", "chunk_rmat", "pair_edges"):
        require(served[name] > 0, f"serve: the fleet launched no {name}")
    naive = serve_compare(dev, tickets)
    print(f"  naive loop [generate(s, 16) for s in fleet]: {len(tickets)} requests, "
          f"{naive:.6f}s ({len(tickets) / naive:.4f} requests/s), against the service's "
          f"{wall:.6f}s; every served request equals generate's")
    exposition = obs.parse_exposition(svc.metrics())
    print("  serve metrics: " + json.dumps(exposition, sort_keys=True))
    del svc, tickets
    torch.cuda.empty_cache()
    step("fleet, naive loop and checks")

    # the fleet again, in turn with the naive loop: traced, under the profiler
    # (the card's activity alone: the fleet is tens of thousands of host steps)
    with obs.capture() as tr:
        (svc, tickets, wall2), groups, pwall = profiled(
            lambda: serve_run(dev, sizes, "fleet again (traced, profiled)"), cpu=False)
    print_breakdown("serve fleet", groups, pwall)
    summary = tr.summary()
    print("  serve traced drain, s by phase: " + ", ".join(
        f"{k} {v:.6f}" for k, v in summary["phases"].items()) + "; spans: " + ", ".join(
        f"{k} {v['count']} / {v['total_s']:.6f}s" for k, v in sorted(summary["spans"].items())))
    del svc, tickets, tr
    torch.cuda.empty_cache()
    step("fleet again")

    # streaming with overlap: the chunks sink against iter_edge_chunks
    p_in, p_out = 2.0 ** -15, 2.0 ** -19
    sbm = api.SBM(n=sizes["serve_n"], blocks=16, p_in=p_in, p_out=p_out, seed=300)
    svc = Service(16, device=dev, slab_batch=16)
    t0 = time.perf_counter()
    k = 0
    for k, (a, b) in enumerate(zip(svc.submit(sbm, sink="chunks", overlap=4).chunks(),
                                   api.iter_edge_chunks(sbm, 16, device=dev)), 1):
        require(a.pe == b.pe and torch.equal(a.edges(), b.edges()),
                f"serve: overlapped SBM chunk {k - 1} differs from iter_edge_chunks'")
    require(k == len(sbm.plan(16).stream_index()), "serve: overlapped SBM chunk count")
    print(f"  serve {sbm} overlap=4, chunks sink: {k} chunks equal iter_edge_chunks', "
          f"{time.perf_counter() - t0:.3f}s with the comparison")

    step("overlapped SBM")
    # RDG: cold (triangulate on admission), then a new seed (plan-cache
    # hit); its CERT rows are 16 slots each, so a slab takes 4096 of them
    # (at the fleet's 16, a request is 27,000 slabs of host work)
    rdg.rdg_structure.cache_clear()
    svc = Service(16, device=dev, slab_batch=4096)
    for seed, what in ((400, "cold"), (401, "reseeded")):
        spec = api.RDG(n=sizes["serve_rdg_n"], dim=2, seed=seed)
        tri = build.LAUNCHES["triangulate"]
        t0 = time.perf_counter()
        t = svc.submit(spec)
        plan_s = time.perf_counter() - t0
        g = t.result()
        torch.cuda.synchronize(dev)
        s = time.perf_counter() - t0
        tri = build.LAUNCHES["triangulate"] - tri
        require(tri > 0, f"serve: RDG {what} admission launched no triangulate")
        require(torch.equal(g.edges, api.generate(spec, 16, device=dev).edges),
                f"serve: RDG {what} differs from generate")
        print(f"  serve {spec} {what}: admitted in {plan_s:.3f}s ({tri} triangulate launches), "
              f"served in {s:.3f}s, {g.m} edges equal generate's; latency {t.latency:.3f}s, "
              f"{svc.stats['slabs']} slabs so far")
    require(svc.cache.stats == {"hits": 1, "misses": 1, "evictions": 0, "entries": 1},
            f"serve: RDG plan cache {svc.cache.stats}")
    del svc, g
    torch.cuda.empty_cache()

    step("RDG")
    # fault reissue over 4 slab rows
    spec = api.GNM(n=sizes["serve_n"], m=sizes["serve_m"], seed=500)
    svc = Service(16, D=4, device=dev, slab_batch=4)
    t = svc.submit(spec)
    svc.inject_fault([1, 2], at_slab=1)
    svc.drain()
    require(svc.scheduler.reissued > 0, "serve: the fault reissued nothing")
    require(torch.equal(t.result().edges, api.generate(spec, 16, device=dev).edges),
            "serve: the reissued request differs from generate")
    print(f"  serve {spec} D=4, rows 1 and 2 dead at slab 1: {svc.scheduler.reissued} slots "
          f"reissued over {svc.stats['slabs']} slabs, edges equal generate's")
    del svc, t
    torch.cuda.empty_cache()

    step("fault reissue")
    # past the staging pair_edges had by capacity: TORUS rows at class 8192
    # (an RGG whose capacity lies in 4097..7261), HYP rows at class 4096
    spec = api.RGG(n=20000, radius=0.45, seed=600, chunks=1)
    plan = spec.plan(1)
    require(4096 < plan.capacity <= 7261 and program_of(plan).capacity == 8192,
            f"serve: RGG capacity {plan.capacity}")
    svc = Service(1, device=dev, slab_batch=2)
    t = svc.submit(spec)
    rgg_slab = svc.scheduler.peek_slab()
    g = t.result()
    require(torch.equal(g.edges, api.generate(spec, 1, device=dev).edges),
            "serve: the class-8192 RGG differs from generate")
    print(f"  serve {spec}: capacity {plan.capacity}, class 8192 (TORUS rows staged by "
          f"their counts), {g.m} edges equal generate's")
    del g, svc, t
    torch.cuda.empty_cache()

    step("past the staging limit")
    # cold plan against reseed, a family each (BENCH_serve.json's plan_reseed)
    fleet, _ = serve_fleet(api, sizes)
    specs = [next(s for s, _ in fleet if type(s).__name__ == f) for f in
             ("GNM", "GNP", "BA", "SBM", "RMAT", "RHG")]
    specs += [api.RGG(n=1 << 16, radius=0.55 * (math.log(1 << 16) / (1 << 16)) ** 0.5, seed=7),
              api.RDG(n=sizes["serve_rdg_n"], dim=2, seed=402)]
    for spec in specs:
        rdg.rdg_structure.cache_clear()
        rgg.rgg_structure.cache_clear()
        t0 = time.perf_counter()
        plan = spec.plan(16, device=dev)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan.reseed(spec.seed + 1)
        torch.cuda.synchronize(dev)
        hot = time.perf_counter() - t0
        print(f"  plan {type(spec).__name__} P=16: cold {cold * 1e6:.1f} us, reseed "
              f"{hot * 1e6:.1f} us ({cold / hot:.2f}x)")
    rdg.rdg_structure.cache_clear()
    step("cold plans and reseeds")
    return {"slabs": slabs, "rgg_slab": rgg_slab}


def slot_kernels():
    """The kernels a slot function calls: ``(module, name, plain version,
    positions (or keywords) of the arguments the call writes into)``."""
    from repro_torch.core import sampling
    from repro_torch.distrib import engine
    from repro_torch.kernels.geom.ref import pair_edges_ref
    from repro_torch.kernels.sampler.ref import (chunk_ba_ref, chunk_decode_ref, chunk_rmat_ref,
                                                 sample_rows_ref)
    return [(sampling, "chunk_sample", sample_rows_ref, (4,)),
            (engine, "chunk_decode", chunk_decode_ref, ()),
            (engine, "chunk_rmat", chunk_rmat_ref, (8,)),
            (engine, "chunk_ba", chunk_ba_ref, (6, 7)),
            (engine, "pair_edges", pair_edges_ref, ())]


def stats_kernels():
    """The kernels ``collect`` calls on its chunks, as :func:`slot_kernels`
    names them, each with the kernel's own name last: ``hist`` through
    ``bincount_ids`` into a degree array, ``close_wedges`` into the triangle
    counts."""
    import importlib
    from repro_torch.kernels.hist.ref import hist_counts_ref
    from repro_torch.kernels.wedges.ref import close_wedges_table_ref

    def bincount_plain(ids, length, out=None):
        return out.add_(hist_counts_ref(ids, length, drop=True))

    def wedges_plain(edges, table, mask=None, count=None, out=None):
        return out.add_(close_wedges_table_ref(edges, table, mask=mask, count=count))

    return [(importlib.import_module("repro_torch.stats.collect"), "bincount_ids",
             bincount_plain, ("out",), "hist"),
            (importlib.import_module("repro_torch.stats.accumulate"), "close_wedges",
             wedges_plain, ("out",), "close_wedges")]


class held_kernels:
    """Within: every kernel call of a slot function also runs the kernel's
    plain version on the same inputs (what the call writes into is cloned
    first), the two are held equal in ``errs``, and the kernel's result
    goes on.  Each kernel thus meets its plain version at the shapes and
    on the data the served slab gives it; ``seen`` counts the calls held.
    With ``first_only`` only each kernel's first call is held (with
    ``per``, a function naming the calling row, its first call on each
    row), and ``plain_s`` sums the seconds the plain versions took;
    ``names`` restricts the holding to those kernels, and ``kernels``
    (:func:`stats_kernels`) holds other calls than the slot functions'.  A
    held call is opaque to the op scan, as the kernel's entry point is."""

    def __init__(self, errs: Errors, what: str, first_only: bool = False, names=None,
                 per=None, kernels=None):
        self.errs, self.what, self.seen, self.undo = errs, what, {}, []
        self.first_only, self.plain_s, self.names = first_only, 0.0, names
        self.per, self.firsts, self.kernels = per, set(), kernels

    def __enter__(self):
        import torch
        from repro_torch.analyze import opscan

        def copy(x):
            if isinstance(x, tuple):
                return tuple(copy(t) for t in x)
            return x.clone() if torch.is_tensor(x) else x

        def pairs(r):
            return (r,) if torch.is_tensor(r) else r

        for mod, attr, plain, writes, *kname in self.kernels or slot_kernels():
            name = kname[0] if kname else attr
            if self.names is not None and name not in self.names:
                continue
            kernel = getattr(mod, attr)

            def both(*a, _k=kernel, _p=plain, _w=writes, _n=name, **kw):
                first = (_n, self.per()) if self.per else _n
                if self.first_only and first in self.firsts:
                    return _k(*a, **kw)
                self.firsts.add(first)
                pa = [copy(x) if i in _w else x for i, x in enumerate(a)]
                pkw = {k: copy(x) if k in _w else x for k, x in kw.items()}
                got = _k(*a, **kw)
                if self.first_only:     # the plain version's seconds alone
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = _p(*pa, **pkw)
                if self.first_only:
                    torch.cuda.synchronize()
                self.plain_s += time.perf_counter() - t0
                for x, y in zip(pairs(got), pairs(want)):
                    self.errs.same(_n, x, y, f"{_n} in {self.what}")
                self.seen[_n] = self.seen.get(_n, 0) + 1
                return got

            # opaque to the op scan as the kernel is: the plain version and
            # the comparison (host reads) are the check's, not the program's
            setattr(mod, attr, opscan.opaque(name)(both))
            self.undo.append((mod, attr, kernel))
        return self

    def __exit__(self, *exc):
        for mod, name, kernel in self.undo:
            setattr(mod, name, kernel)


def serve_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of path 3f: the first slab of each of the fleet's packing
    groups and the class-8192 RGG slab, run as ``tick`` runs them, with
    every kernel held against its plain version on its inputs there; HYP
    rows of 3000 points at class 4096; ``pair_edges`` timed at the
    fleet's pair slab (the kernels line's serving row)."""
    import torch
    from repro_torch.distrib import runtime
    from repro_torch.kernels.geom import ops as G
    from repro_torch.kernels.geom.ref import GEOM_HYP, pair_edges_ref
    from torch_geom_rows import pair_rows

    seen = {}
    for prog, valid, rows in out["slabs"] + [out["rgg_slab"]]:
        what = (f"the served {prog.plan_kind} slab at class {prog.capacity} "
                f"({int(valid.sum())} rows)")
        t0 = time.perf_counter()
        # check=False: the held kernels compare on the host, which the
        # contract scan would rightly refuse; 3f and 3g scan the slab programs
        with held_kernels(errs, what) as held:
            payload, ok = runtime.run_slab(prog.slot_fn, prog.signature(), valid, rows, dev,
                                           check=False, **prog.slot_kwargs(rows))
        require(bool(ok.any()), f"{what}: no edge kept")
        print(f"  {what}: every kernel equals its plain version ({held.seen}), "
              f"{time.perf_counter() - t0:.3f}s")
        for k, c in held.seen.items():
            seen[k] = seen.get(k, 0) + c
        del payload, ok
        torch.cuda.empty_cache()
    for name in ("chunk_sample", "chunk_decode", "chunk_rmat", "chunk_ba", "pair_edges"):
        require(seen.get(name, 0) > 0, f"serve: no served slab held {name} against its plain "
                                       f"version")

    # HYP rows past the staging pair_edges had by capacity: 3000 points a
    # side at class 4096
    hrows = pair_rows(2, 3000, 2, seed=3000, device=dev, kinds=(GEOM_HYP,))
    hrows[-1][:] = True
    kw = dict(capacity=4096, dim=2, kinds=(GEOM_HYP,), stage={GEOM_HYP: 3000})
    ea, ka = G.pair_edges(*hrows, **kw)
    eb, kb = pair_edges_ref(*hrows, **kw)
    errs.same("pair_edges", ea, eb, "pair_edges edges, HYP rows of 3000 at class 4096")
    errs.same("pair_edges", ka, kb, "pair_edges keep, HYP rows of 3000 at class 4096")
    ec, kc = G.pair_edges(*hrows, capacity=3000, dim=2, kinds=(GEOM_HYP,))
    require(int(ka.sum()) > 0 and all(torch.equal(ea[r][ka[r]], ec[r][kc[r]]) for r in range(2)),
            "serve: HYP rows at class 4096 differ from their own capacity 3000")
    print(f"  pair_edges HYP rows of 3000 points at class 4096 (stage 3000): {int(ka.sum())} "
          f"edges, equal to the plain version's and to capacity 3000's")
    del ea, ka, eb, kb, ec, kc, hrows
    torch.cuda.empty_cache()

    # pair_edges at the fleet's pair slab, as the slab program calls it
    prog, valid, rows = next(x for x in out["slabs"] if x[0].plan_kind == "pair")
    _, *tabs = runtime._upload([valid] + list(rows), dev)
    tabs = [t.reshape(-1, *t.shape[2:]) for t in tabs]
    kw = dict(capacity=prog.capacity, dim=prog.dim, kinds=prog.kinds,
              stage=prog.slot_kwargs(rows)["stage"])
    (ea, ka), ms, med = timed(lambda: G.pair_edges(*tabs, **kw), reps=20,
                              label="pair_edges, served pair slab")
    (eb, kb), plain_ms = sync_time(lambda: pair_edges_ref(*tabs, **kw), reps=1)
    errs.same("pair_edges", ea, eb, "pair_edges edges at the served pair slab")
    errs.same("pair_edges", ka, kb, "pair_edges keep at the served pair slab")
    live = tabs[-1]
    points = int(((tabs[3] + tabs[4]) * live).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in tabs)
    # 17 bytes written per slot; 1 + 2*2 Threefry blocks per regenerated point
    bytes_s, ops_s = bound_terms(cost().pair_edges(in_bytes, len(live), prog.capacity, points))
    bound = max(bytes_s, ops_s) * 1e3
    print(f"  pair_edges shape: the fleet's pair slab, {len(live)} rows ({int(valid.sum())} "
          f"filled) x {prog.capacity}^2 slots, stage {kw['stage']}, {points} points, "
          f"{int(ka.sum())} edges kept; median {med:.6f} ms (mean {ms:.6f}), plain "
          f"{plain_ms:.3f} ms, bound {bound:.6f} ms "
          f"({'bytes' if bytes_s >= ops_s else 'operations'}): {100 * bound / med:.1f} % of it")
    del ea, ka, eb, kb, tabs
    torch.cuda.empty_cache()
    return [("pair_edges", "src/repro_torch/kernels/geom/csrc/geom.cu",
             "src/repro/distrib/engine.py:1050", ms, med, plain_ms, bytes_s, ops_s, None,
             f"the fleet's pair slab: {len(live)} rows at class {prog.capacity}")]


def same_outputs(name: str, a: tuple, b: tuple) -> None:
    """A registry case's outputs on the card against the CPU's, bit for
    bit: ``(payload, valid)`` pairs where valid (padding slots are the
    kernels' own), a kernel case whole (``triangulate``: ``simp`` and
    ``alive`` on the ``ok`` rows)."""
    import torch

    require(len(a) == len(b), f"{name}: {len(a)} outputs on the card, {len(b)} on the CPU")
    if name.startswith("kernels/delaunay"):
        ok = b[2]
        require(torch.equal(a[2].cpu(), ok), f"{name}: ok differs from the CPU's")
        for x, y in zip(a[:2], b[:2]):
            require(torch.equal(x.cpu()[ok], y[ok]), f"{name}: output differs from the CPU's")
        return
    if name.startswith("kernels/"):
        for x, y in zip(a, b):
            require(torch.equal(x.cpu(), y), f"{name}: output differs from the CPU's")
        return
    for (pa, va), (pb, vb) in zip(zip(a[::2], a[1::2]), zip(b[::2], b[1::2])):
        va = va.cpu()
        require(torch.equal(va, vb), f"{name}: valid mask differs from the CPU's")
        require(torch.equal(pa.cpu()[va], pb[vb]), f"{name}: payload differs from the CPU's")


def phase_analyze(dev, sizes: dict) -> dict:
    """3g, contract checking: the port and this script lint clean; every
    registry case runs on the card under the op scan and sync-debug mode
    "error" with zero findings, its outputs equal to the same case's on
    the CPU (plain versions); each planted violation is found exactly
    once on the card, by the scan and by ``runtime.run(check=True)``; and
    ``generate(GNM(2^24, 2^28), 1)`` with ``check=True`` (cold cache)
    against ``check=False``, in turns."""
    import torch
    from torch_planted import Planted
    from repro_torch import api
    from repro_torch.analyze import lint, opscan, programs
    from repro_torch.distrib import runtime

    t0 = time.perf_counter()
    found = lint.lint_paths([str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py")])
    require(not found, "lint: " + "; ".join(f.format() for f in found))
    lint_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    card = programs.scan_programs(device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = {r.name: r for r in programs.scan_programs(device="cpu")}
    cpu_s = time.perf_counter() - t0
    launches: dict = {}
    for r in card:
        require(r.ok, f"{r.name} on the card: {r.error or [f.to_json() for f in r.scan.findings]}")
        require(cpu[r.name].ok, f"{r.name} on the CPU: {cpu[r.name].error}")
        same_outputs(r.name, r.outputs, cpu[r.name].outputs)
        for k, n in r.launches.items():
            launches[k] = launches.get(k, 0) + n
    print(f"  lint: 0 findings ({lint_s:.3f}s); registry: {len(card)} cases, 0 findings on the "
          f"card under sync-debug \"error\" ({card_s:.3f}s) and on the CPU ({cpu_s:.3f}s), "
          f"outputs equal bit for bit; entry-point calls {launches}")
    for r in card:
        print(f"    {r.name:<32} {r.seconds * 1e3:9.3f} ms  ops {r.flops:,.0f}  bytes "
              f"{r.bytes:,.0f}  launches {r.launches}")

    base = api.GNM(n=64, m=128, seed=1, chunks=4).plan(4)
    for rule in ("host-callback", "dynamic-shape", "nondeterministic-rng"):
        planted = Planted(base, rule, tag="chip")
        _, rep = opscan.scan_call(runtime.run, planted, dev, check=False, sync_debug=True)
        require([f.rule for f in rep.findings] == [rule],
                f"planted {rule}: the card's scan found {[f.rule for f in rep.findings]}")
        try:
            runtime.run(planted, dev, check=True)
            require(False, f"planted {rule}: run(check=True) did not raise")
        except AssertionError as e:
            require(rule in str(e), f"planted {rule}: run(check=True) raised {e}")
        print(f"  planted {rule}: found once on the card ({rep.findings[0].detail})")

    # five rounds of True, False, False, True, each on a cold cache
    spec = api.GNM(n=sizes["gnm_n"], m=sizes["gnm_m"], seed=1)
    walls = {True: [], False: []}
    for check in (True, False, False, True) * 5:
        runtime.cache_clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = api.generate(spec, 1, device=dev, check=check)
        torch.cuda.synchronize()
        walls[check].append(time.perf_counter() - t0)
        require(g.m == sizes["gnm_m"], f"GNM generate with check={check}: {g.m} edges")
        del g
        torch.cuda.empty_cache()
    on, off = (sorted(walls[c]) for c in (True, False))
    print(f"  generate(GNM(2^24, 2^28), 1) on a cold slot-function cache, check True/False/"
          f"False/True x 5: check=True {', '.join(f'{w:.6f}' for w in walls[True])} s, "
          f"check=False {', '.join(f'{w:.6f}' for w in walls[False])} s; medians "
          f"{on[5] * 1e3:.3f} / {off[5] * 1e3:.3f} ms (quartiles {on[2] * 1e3:.3f}-"
          f"{on[7] * 1e3:.3f} / {off[2] * 1e3:.3f}-{off[7] * 1e3:.3f}): the check's "
          f"one-time cost {(on[5] - off[5]) * 1e3:.3f} ms")
    return {"cases": len(card)}


def analyze_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of 3g: nothing to time beyond the path's own turns."""
    return []


LM_ARCH = "qwen3_0p6b"
# aten ops that make views (no kernel), counted apart in a decode step's census
LM_VIEW_OPS = frozenset({"aten::view", "aten::_unsafe_view", "aten::unsqueeze",
                         "aten::squeeze", "aten::permute", "aten::expand", "aten::slice",
                         "aten::select", "aten::transpose", "aten::t", "aten::alias",
                         "aten::as_strided", "aten::split", "aten::split_with_sizes",
                         "aten::chunk", "aten::unbind", "aten::detach"})
LM_TOL = 1e-4           # card against CPU, float32: of max |logit| (and the loss, absolute)
# float32 teacher-forced decode against the full forward at full width: the
# two run other GEMM shapes (cuBLAS picks other kernels, summing in other
# orders; TF32 off), about 2e-6 of max |logit| over 28 layers
LM_DECODE_TOL = 1e-4
# bf16 prefill's last-position logits against the float32 forward on the
# same masters at full width: bf16 keeps 8 significant bits, rounding each
# op's output; qwen3's width at vocab 8192 on the CPU gave 5.7e-3, 6.4e-3
# and 8.6e-3 of max |logit| at 2, 4 and 8 layers: 5e-2 leaves room for 28
LM_BF16_TOL = 5e-2


def lm_groups(key: str) -> str:
    """The LM's breakdown groups of a profiler kernel name: the GEMMs
    (cuBLAS, CUTLASS), softmax and reductions, copies and casts, the rest."""
    k = key.lower()
    if "gemm" in k or "nvjet" in k or "cutlass" in k or "xmma" in k or "matmul" in k:
        return "gemm"
    if "softmax" in k or "reduce" in k:
        return "softmax/reduce"
    if "copy" in k or "cast" in k or "memcpy" in k or "memset" in k or "fill" in k:
        return "copy/cast/fill"
    return "elementwise/other"


class held_lm_kernels:
    """Within: ``rhg.hyp_edges`` and the chunk program's ``sample_rows`` and
    ``chunk_decode`` (``engine``'s, which ``gnm_undirected_pe`` runs)
    launch their kernels and hold each result against the plain version
    on the same inputs (``hyp_edges``' on the CPU), so each meets it at
    the pipeline's shapes and data; ``tables`` keeps every ``hyp_edges``
    call's inputs (on the card) and hit count, ``seen`` counts the calls
    held."""

    def __init__(self, errs: Errors):
        self.errs, self.tables, self.seen, self.undo = errs, [], {}, []

    def __enter__(self):
        from repro_torch.core import rhg
        from repro_torch.distrib import engine
        from repro_torch.kernels.pairmask.ref import hyp_edges_ref
        from repro_torch.kernels.sampler.ref import chunk_decode_ref, sample_rows_ref
        errs, seen = self.errs, self.seen
        edges, sample, decode = rhg.hyp_edges, engine.sample_rows, engine.chunk_decode

        def held_edges(q, c, q_gid, c_gid, segments, cosh_r):
            out = edges(q, c, q_gid, c_gid, segments, cosh_r)
            cpu = [t.cpu() for t in (q, c, q_gid, c_gid, segments)]
            errs.same("hyp_edges", out.cpu(), hyp_edges_ref(*cpu, cosh_r),
                      f"hyp_edges at rhg_pe's table of {len(segments)} segments, q [{len(q)}, 4], "
                      f"c [{len(c)}, 4]")
            self.tables.append(((q, c, q_gid, c_gid, segments, cosh_r), len(out)))
            seen["hyp_edges"] = seen.get("hyp_edges", 0) + 1
            return out

        def held_sample(key, universe, count, capacity):
            out = sample(key, universe, count, capacity)
            errs.same("chunk_sample", out, sample_rows_ref(key, universe, count, capacity),
                      f"chunk_sample at gnm_undirected_pe's [{key.shape[0]}, {capacity}]")
            seen["chunk_sample"] = seen.get("chunk_sample", 0) + 1
            return out

        def held_decode(vals, kind, params, count, owned):
            out = decode(vals, kind, params, count, owned)
            for a, b in zip(out, chunk_decode_ref(vals, kind, params, count, owned)):
                errs.same("chunk_decode", a, b,
                          f"chunk_decode at gnm_undirected_pe's {list(vals.shape)}")
            seen["chunk_decode"] = seen.get("chunk_decode", 0) + 1
            return out

        for mod, name, fn in ((rhg, "hyp_edges", held_edges),
                              (engine, "sample_rows", held_sample),
                              (engine, "chunk_decode", held_decode)):
            self.undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.undo:
            setattr(mod, name, fn)


@contextlib.contextmanager
def timed_rhg_pe(walls: list):
    """Within: every ``rhg.rhg_pe`` call appends ``(P, pe, wall s)`` to
    ``walls`` (it returns host arrays: its wall ends after the card's
    work)."""
    from repro_torch.core import rhg

    real = rhg.rhg_pe

    def timed(params, P, pe, *a, **k):
        t0 = time.perf_counter()
        out = real(params, P, pe, *a, **k)
        walls.append((P, pe, time.perf_counter() - t0))
        return out
    rhg.rhg_pe = timed
    try:
        yield walls
    finally:
        rhg.rhg_pe = real


def rhg_pe_line(walls: list) -> str:
    """``rhg_pe`` walls by P: a run is the calls of shards 0 .. P - 1,
    summed."""
    runs: dict = {}
    for P, pe, w in walls:
        if pe == 0:
            runs.setdefault(P, []).append(0.0)
        runs[P][-1] += w
    return "; ".join(f"P={P}{' (all shards)' if P > 1 else ''}: "
                     + ", ".join(f"{w:.6f}" for w in ws) + " s"
                     for P, ws in sorted(runs.items()))


def lm_pipeline(dev, errs: Errors) -> dict:
    """3h, part 1: ``make_global_batch`` at ``launch/train.py``'s data
    config on the card, timed with the graphs cold (each ``rhg_pe`` call's
    wall printed); then again with every ``hyp_edges``, ``chunk_sample``
    and ``chunk_decode`` launch held against its plain version; every
    batch's digests against ``golden/data.json`` and against the port on
    the CPU.  ``rhg_pe`` must make one ``hyp_edges`` launch a graph and no
    ``pair_mask`` launch."""
    from torch_golden import batch_digests
    from repro_torch.data import pipeline
    from repro_torch.kernels import build

    doc = json.loads((ROOT / "src" / "repro_torch" / "golden" / "data.json").read_text())
    configs = [(pipeline.DataConfig(**e["params"]), e["step"], e) for e in doc["batches"]]
    pipeline._local_graph.cache_clear()
    lm_names = ("hyp_edges", "pair_mask", "chunk_sample", "chunk_decode")
    before = {k: build.LAUNCHES[k] for k in lm_names}
    walls, graph_walls = [], []
    with timed_rhg_pe(graph_walls):
        for cfg, step, _ in configs:
            t0 = time.perf_counter()
            pipeline.make_global_batch(cfg, step, device=dev)
            walls.append(time.perf_counter() - t0)
    launches = {k: build.LAUNCHES[k] - before[k] for k in lm_names}
    graphs = len({(c.num_shards, sh) for c, _, _ in configs if c.kind == "rhg_walk"
                  for sh in range(c.num_shards)})
    print(f"  pipeline on the card, graphs cold: {len(configs)} batches in {sum(walls):.3f}s "
          f"(" + ", ".join(f"{c.kind}/{c.num_shards} step {s} {w:.3f}s"
                           for (c, s, _), w in zip(configs, walls)) + f"); launches "
          f"{launches} ({card_line()})")
    print(f"  a pass: hyp_edges {launches['hyp_edges']} launches, pair_mask "
          f"{launches['pair_mask']}, for {graphs} rhg_pe graphs; rhg_pe walls, graphs cold: "
          f"{rhg_pe_line(graph_walls)}")
    require(launches["pair_mask"] == 0 and launches["hyp_edges"] == graphs == len(graph_walls),
            f"rhg_pe made {launches} launches for {graphs} graphs: one hyp_edges launch a graph "
            "and no pair_mask launch expected")

    pipeline._local_graph.cache_clear()
    before = {k: build.LAUNCHES[k] for k in lm_names}
    with held_lm_kernels(errs) as held:
        card = [pipeline.make_global_batch(cfg, step, device=dev) for cfg, step, _ in configs]
    held_launches = {k: build.LAUNCHES[k] - before[k] for k in lm_names}
    print(f"  a held pass: launches {held_launches}")
    require(held_launches == launches and all(held.seen.get(k, 0) == n
                                              for k, n in launches.items()),
            f"held run made {held.seen} calls and {held_launches} launches, the timed run "
            f"launched {launches}")
    t0 = time.perf_counter()
    cpu = [pipeline.make_global_batch(cfg, step, device="cpu") for cfg, step, _ in configs]
    cpu_s = time.perf_counter() - t0
    for (cfg, step, e), a, b in zip(configs, card, cpu):
        want = {k: e[k] for k in ("tokens", "labels", "positions")}
        require(batch_digests(a) == want, f"{cfg.kind}/{cfg.num_shards} step {step}: card "
                "tokens differ from golden/data.json")
        require(batch_digests(b) == want, f"{cfg.kind}/{cfg.num_shards} step {step}: CPU "
                "tokens differ from golden/data.json")
        require(list(a["tokens"].shape) == e["shape"], "batch shape")
    tables = held.tables
    print(f"  pipeline: {len(configs)} batches' tokens, labels, positions == golden/data.json "
          f"on the card and on the CPU ({cpu_s:.3f}s); held {held.seen}, each launch == its "
          f"plain version (max |err| hyp_edges {errs.max['hyp_edges']}, chunk_sample "
          f"{errs.max['chunk_sample']}, chunk_decode {errs.max['chunk_decode']}); hyp_edges "
          f"tables: " + ", ".join(
              f"{len(a[4])} segments, q [{len(a[0])}, 4], c [{len(a[1])}, 4], "
              f"{int((a[4][:, 1] * a[4][:, 3]).sum())} pairs, {hits} hits" for a, hits in tables))
    prompts = card[[i for i, (c, s, _) in enumerate(configs)
                    if c.kind == "rhg_walk" and c.num_shards == 4 and s == 0][0]]["tokens"]
    # the first graph is rhg_walk's at one shard: rhg_pe at P = 1, for phase 4
    require(configs[0][0].kind == "rhg_walk" and configs[0][0].num_shards == 1,
            "the first batch is not rhg_walk's at one shard")
    return {"prompts": prompts, "hyp_tables": tables, "rhg_pe_cold": graph_walls}


def lm_smoke_archs(dev) -> None:
    """3h, part 2: the ten architectures at smoke size, float32, the same
    weights on the card and on the CPU: ``forward`` logits, ``lm_loss``,
    and (causal ones) teacher-forced ``decode_step`` against the full
    forward, within ``LM_TOL``."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  ten architectures at smoke size, float32, the card against the CPU "
          f"(tolerance {LM_TOL} of max |logit|; {card_line()}):")
    for arch in ARCHS:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch)
        cpu = T.model_init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        B, S = 2, 32
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
        batch = {"positions": torch.arange(S, dtype=torch.int32).repeat(B, 1),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
        if cfg.frontend != "none":
            batch["embeds"] = cpu["embed"]["tok"].detach()[toks.long()]
        else:
            batch["tokens"] = toks
        out = {}
        with torch.no_grad():
            for where, p in (("cpu", cpu), ("card", card)):
                d = p["embed"]["tok"].device
                b = {k: v.to(d) for k, v in batch.items()}
                h, _, _ = T.forward(p, cfg, b)
                logits = (h @ p["embed"]["head"]).cpu()
                loss = float(T.lm_loss(p, cfg, b)[0])
                dec = None
                if cfg.causal:
                    caches = T.caches_init(cfg, B, S, torch.float32, d)
                    steps = []
                    for t in range(S):
                        lg, caches = T.decode_step(p, cfg, toks[:, t:t + 1].to(d),
                                                   b["positions"][:, t:t + 1], caches)
                        steps.append(lg.cpu())
                    dec = torch.cat(steps, dim=1)
                out[where] = (logits, loss, dec)
        (lc, sc, dc), (lg, sg, dg) = out["cpu"], out["card"]
        scale = float(lc.abs().max())
        err = float((lg - lc).abs().max())
        require(torch.isfinite(lg).all() and err <= LM_TOL * scale,
                f"{arch}: card logits differ from the CPU's by {err} (scale {scale})")
        require(abs(sg - sc) <= LM_TOL, f"{arch}: card loss {sg} against the CPU's {sc}")
        line = f"  {arch:<22} logits |card - cpu| {err:.3e} of {scale:.3f}, loss {sg:.6f} " \
               f"(cpu {sc:.6f})"
        if dc is not None:
            derr = float((dg - dc).abs().max())
            ferr = float((dg - lg).abs().max())
            require(derr <= LM_TOL * scale, f"{arch}: card decode differs from the CPU's {derr}")
            require(ferr <= (5e-3 if cfg.moe else LM_TOL) * scale,
                    f"{arch}: card decode differs from its forward by {ferr}")
            line += f", decode |card - cpu| {derr:.3e}, |decode - forward| {ferr:.3e}"
        print(line + f" ({time.perf_counter() - t0:.3f}s)")


def lm_full_width(dev, prompts, sizes: dict) -> dict:
    """3h, part 3: Qwen3-0.6B at full width on the card: ``model_init``
    from a seeded generator, ``generate`` in bf16 for the pipeline's
    prompts (prefill and greedy decode timed apart, in turns), the peak
    memory, the device's idle share under the profiler, prefill's share
    of the bf16 peak and decode's of HBM bandwidth; then float32
    teacher-forced decode against the full forward."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import H100
    from repro_torch.models import transformer as T
    from repro_torch.train import serve

    c = cost()
    cfg = get_config(LM_ARCH)
    B, S, steps = sizes["lm_batch"], sizes["lm_prompt"], sizes["lm_steps"]
    prompts = np.ascontiguousarray(prompts[:B, :S])
    require(prompts.shape == (B, S), f"prompts {prompts.shape}")
    t0 = time.perf_counter()
    params = T.model_init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params:,} float32 masters ({n_params * 4 / 2 ** 30:.3f} GiB) initialised on the "
          f"card in {time.perf_counter() - t0:.3f}s; compute {cfg.dtype}")

    t0 = time.perf_counter()
    serve.generate(params, cfg, prompts[:, :32], 2)         # warm-up: cuBLAS handles, plans
    print(f"  [warm-up generate {time.perf_counter() - t0:.3f}s]")
    pre, gen = [], []
    out = None
    for turn in ("prefill", "generate", "generate", "prefill"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if turn == "prefill":
            caches, logits = serve.prefill(params, cfg, torch.from_numpy(prompts), S + steps)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
            del caches, logits
        else:
            out = serve.generate(params, cfg, prompts, steps)
            torch.cuda.synchronize()
            gen.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
    require(out.shape == (B, steps) and out.dtype == np.int32, f"generate gave {out.shape}")
    require(((out >= 0) & (out < cfg.vocab)).all(), "generated tokens out of the vocabulary")
    p_s, g_s = min(pre), min(gen)
    step_s = (g_s - p_s) / steps
    pc = c.lm_prefill(cfg, B, S)
    dc = c.lm_decode(cfg, B, S + steps // 2)
    pre_share = pc.ops / H100.ops_per_s("bf16") / p_s
    dec_share = dc.bytes / H100.bytes_per_s / step_s
    card = card_line()
    print(f"  generate B={B} prompts of {S} + {steps} greedy steps, {cfg.dtype} ({card}): "
          f"prefill {', '.join(f'{x:.6f}' for x in pre)} s ({B * S / p_s:.1f} tokens/s, "
          f"{pc.ops / p_s / 1e12:.3f} TFLOP/s, {100 * pre_share:.3f} % of the bf16 dense peak; "
          f"its bound {pc.bound_s() * 1e3:.6f} ms by {pc.bound_by()}); generate "
          f"{', '.join(f'{x:.6f}' for x in gen)} s; decode {step_s * 1e3:.6f} ms a step "
          f"({B / step_s:.1f} tokens/s; {dc.bytes / step_s / 1e9:.3f} GB/s of weights and KV "
          f"cache, {100 * dec_share:.3f} % of HBM bandwidth; its bound "
          f"{dc.bound_s() * 1e3:.6f} ms by {dc.bound_by()}); peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    # one decode step's aten census on the card, under sync-debug "error":
    # the host's dispatch per step, and any op that waits for the card
    from repro_torch.analyze import opscan
    caches, logits = serve.prefill(params, cfg, torch.from_numpy(prompts), S + 1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos1 = torch.full((B, 1), S, dtype=torch.int32, device=dev)
    with torch.no_grad(), opscan.trace(sync_debug=True) as census:
        T.decode_step(params, cfg, tok, pos1, caches)
    n_ops = sum(census.values())
    n_views = sum(n for k, n in census.items() if opscan._split(k)[0] in LM_VIEW_OPS)
    synced = {k: n for k, n in census.items() if opscan.TAG_SYNC in opscan._split(k)[1]}
    print(f"  one decode step: {n_ops} aten calls ({n_ops / cfg.n_layers:.1f} a layer), "
          f"{n_views} of them views; {sum(synced.values())} that wait for the card {synced}; "
          f"{step_s * 1e6 / n_ops:.3f} µs of the step's wall a call")
    del caches, logits
    t0 = time.perf_counter()
    prof_steps = sizes["lm_profiled_steps"]
    _, groups, wall = profiled(lambda: serve.generate(params, cfg, prompts, prof_steps),
                               by=lm_groups, cpu=False)
    print_breakdown(f"generate of {prof_steps} steps ({card})", groups, wall)
    print(f"  [profiled run and its reading {time.perf_counter() - t0:.3f}s]")

    # float32 at the same width: teacher-forced decode of the last
    # positions against the full forward's logits on the same masters
    f32 = cfg.replace(dtype="float32")
    K = sizes["lm_check_steps"]
    S0 = S - K
    toks = torch.from_numpy(prompts).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        h, _, _ = T.forward(params, f32, {"tokens": toks, "positions": pos})
        full = (h[:, S0 - 1:] @ params["embed"]["head"]).float()
        del h
        caches, last = serve.prefill(params, f32, toks[:, :S0], S)
        dec = [last[:, None]]
        for t in range(S0, S):
            lg, caches = T.decode_step(params, f32, toks[:, t:t + 1], pos[:, t:t + 1], caches)
            dec.append(lg)
        dec = torch.cat(dec, dim=1).float()
        _, last16 = serve.prefill(params, cfg, toks, S)
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    require(torch.isfinite(dec).all() and err <= LM_DECODE_TOL * scale,
            f"float32 teacher-forced decode differs from the forward by {err} (scale {scale})")
    require(last16.dtype == torch.bfloat16, f"bf16 prefill gave {last16.dtype} logits")
    want = full[:, -1]
    err16 = float((last16.float() - want).abs().max())
    scale16 = float(want.abs().max())
    same_top = int((last16.float().argmax(-1) == want.argmax(-1)).sum())
    require(torch.isfinite(last16).all() and err16 <= LM_BF16_TOL * scale16,
            f"bf16 prefill logits differ from the float32 forward's by {err16} (scale {scale16})")
    print(f"  bf16 prefill against the float32 forward on the same masters, position {S - 1}: "
          f"max |err| {err16:.3e} of {scale16:.3f} ({err16 / scale16:.3e} of it; tolerance "
          f"{LM_BF16_TOL}), the same top token in {same_top} of {B} rows")
    print(f"  float32 at full width: prefill {S0} + {K} teacher-forced decode steps against "
          f"the full forward's logits at positions {S0 - 1}..{S - 1}: max |err| {err:.3e} of "
          f"{scale:.3f} (tolerance {LM_DECODE_TOL} of it; {time.perf_counter() - t0:.3f}s, "
          f"{card})")
    del params, caches, full, dec, last16
    torch.cuda.empty_cache()
    return {"prefill_s": p_s, "step_s": step_s}


def phase_lm(dev, sizes: dict) -> dict:
    """Phase 3h: the LM stack's serving path (``--only lm``): the data
    pipeline on the card, the ten architectures at smoke size against the
    CPU, and Qwen3-0.6B at full width served in bf16."""
    errs = Errors()
    t0 = time.perf_counter()
    out = lm_pipeline(dev, errs)
    print(f"  [3h pipeline {time.perf_counter() - t0:.3f}s]", flush=True)
    t1 = time.perf_counter()
    lm_smoke_archs(dev)
    print(f"  [3h smoke architectures {time.perf_counter() - t1:.3f}s]", flush=True)
    t1 = time.perf_counter()
    out.update(lm_full_width(dev, out["prompts"], sizes))
    print(f"  [3h full width {time.perf_counter() - t1:.3f}s]", flush=True)
    out["errs"] = errs
    return out


def host_table(args) -> tuple:
    """A ``hyp_edges`` call's inputs as host numpy arrays (and cosh R)."""
    return tuple(a.cpu().numpy() for a in args[:5]) + (args[5],)


def dense_route(table, dev):
    """The dense route on a ``hyp_edges`` table, as ``rhg_pe`` ran it before
    ``hyp_edges`` (``_adjacency`` and ``emit``): a segment at a time, its
    rows padded to 128-row blocks of 8 columns, uploaded, the dense hyp
    ``pair_mask`` launched, the int8 mask copied back, ``astype(bool)``,
    ``np.nonzero``, the gid filter.  The hits ``[K, 2]`` in emit order."""
    import numpy as np
    from repro_torch.kernels.pairmask.ops import pair_mask

    q, c, q_gid, c_gid, seg, cosh_r = table
    hits = [np.zeros((0, 2), np.int64)]
    for qo, ql, co, cl in seg.tolist():
        qp, cp = padded_blocks(table, (qo, ql, co, cl), dev)
        mask = pair_mask(qp, cp, cosh_r, tile="hyp").cpu().numpy()[:ql, :cl].astype(bool)
        ii, jj = np.nonzero(mask)
        u, v = q_gid[qo + ii], c_gid[co + jj]
        hits.append(np.stack([u[u != v], v[u != v]], axis=1))
    return np.concatenate(hits)


def padded_blocks(table, segment, dev):
    """One segment's query and candidate rows as the dense route handed
    them to ``pair_mask``: 8 columns, padded to 128-row blocks, on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.kernels.hypdist.ops import pad_features

    q, c = table[:2]
    qo, ql, co, cl = segment
    qf, cf = np.zeros((ql, 8)), np.zeros((cl, 8))
    qf[:, :4], cf[:, :4] = q[qo:qo + ql], c[co:co + cl]
    return (torch.from_numpy(pad_features(qf)).to(dev),
            torch.from_numpy(pad_features(cf)).to(dev))


def compact_route(table, dev):
    """This route on the same table, as ``rhg._Segments.edges`` runs it:
    one upload of the features, one of the gids and table, one
    ``hyp_edges`` call, the hits copied back."""
    import numpy as np
    import torch
    from repro_torch.kernels.pairmask.ops import hyp_edges

    q, c, q_gid, c_gid, seg, cosh_r = table
    f = torch.from_numpy(np.concatenate([q, c])).to(dev)
    n = torch.from_numpy(np.concatenate([q_gid, c_gid, seg.reshape(-1)])).to(dev)
    Q, C = len(q), len(c)
    return hyp_edges(f[:Q], f[Q:], n[:Q], n[Q:Q + C], n[Q + C:].view(-1, 4), cosh_r).cpu().numpy()


def route_turns(tables: list, dev, reps: int) -> dict:
    """Both routes over ``tables`` (summed) in turns, dense, compact,
    compact, dense, ``reps`` runs a turn, each on the host clock (they end
    in host arrays); their hits must be equal."""
    import numpy as np

    hosts = [host_table(a) for a in tables]
    walls = {"dense": [], "compact": []}
    for turn in ("dense", "compact", "compact", "dense"):
        route = dense_route if turn == "dense" else compact_route
        for _ in range(reps):
            t0 = time.perf_counter()
            got = [route(t, dev) for t in hosts]
            walls[turn].append(time.perf_counter() - t0)
        if turn == "compact":
            require(all(np.array_equal(a, b) for a, b in zip(got, want)),
                    "hyp_edges' hits differ from the dense route's")
        want = got
    return walls


def lm_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of 3h: ``hyp_edges`` at ``rhg_pe``'s table at P = 1 (CUDA
    events, a replayed CUDA graph of its passes, the profiler) beside its
    plain version and its bound; the dense route it replaced (``pair_mask``
    a segment, masks copied back, ``np.nonzero``) against it in turns on
    the same segments at P = 1 and P = 4; ``rhg_pe``'s walls, warm; and
    ``pair_mask``'s hyp tile at the largest segment, on the dense route's
    padded blocks."""
    import statistics
    import torch
    from repro_torch.core import rhg
    from repro_torch.kernels.pairmask.ops import hyp_edges, hyp_edges_into, pair_mask
    from repro_torch.kernels.pairmask.ref import hyp_edges_ref, pair_mask_ref

    for k in ("hyp_edges", "chunk_sample", "chunk_decode"):
        errs.max[k] = max(errs.max[k], out["errs"].max[k])
    card = card_line()
    (args, hits), rest = out["hyp_tables"][0], out["hyp_tables"][1:]
    q, c, _, _, seg, cosh_r = args
    pairs = int((seg[:, 1] * seg[:, 3]).sum())
    res, h_ms, h_med = timed(lambda: hyp_edges(*args), reps=50,
                             label="hyp_edges, rhg_pe's table at P = 1")
    ref, h_plain = sync_time(lambda: hyp_edges_ref(*args), reps=3)
    errs.same("hyp_edges", res, ref, "hyp_edges at rhg_pe's table at P = 1 (plain on the card)")
    into = torch.full_like(res, -1)
    dev_ms = graph_ms_per_call(lambda: hyp_edges_into(*args, into), 50)
    errs.same("hyp_edges", into, res, "hyp_edges' passes replayed from a CUDA graph")
    _, groups, _ = profiled(lambda: [hyp_edges(*args) for _ in range(50)])
    prof_ms = groups["hyp_edges"] / 50 if "hyp_edges" in groups else None
    bytes_s, ops_s = bound_terms(cost().hyp_edges(len(q), len(c), pairs, len(res)))
    bound = max(bytes_s, ops_s) * 1e3
    require(len(res) == hits, f"hyp_edges gave {len(res)} hits, {hits} on path 3h")
    print(f"  hyp_edges shape: rhg_pe's table at P = 1, {len(seg)} segments, q [{len(q)}, 4], "
          f"c [{len(c)}, 4] float64, {pairs} pairs, {len(res)} hits ({card}); median "
          f"{h_med:.6f} ms (mean {h_ms:.6f}, the host's read of the total included); device "
          f"{dev_ms:.6f} ms a call by graph replay of its four passes, {fmt_ms(prof_ms)} by the "
          f"profiler (its kernels; all device time "
          f"{sum(groups.values()) / 50 if groups else 0:.6f} ms a call); plain {h_plain:.6f} ms "
          f"on the card; bound {bound:.6f} ms ({'bytes' if bytes_s >= ops_s else 'operations'}: "
          f"bytes {bytes_s * 1e3:.6f}, float64 operations {ops_s * 1e3:.6f}): "
          f"{dev_ms / bound:.2f}x the bound by graph replay")

    for what, tables in (("P = 1", [args]), ("P = 4, all four shards", [a for a, _ in rest])):
        walls = route_turns(tables, dev, reps=3)
        d, k = (statistics.median(walls[r]) * 1e3 for r in ("dense", "compact"))
        print(f"  rhg_pe's adjacency at {what}, in turns (dense, compact, compact, dense; 3 runs "
              f"a turn, host clock, ms): the dense route ({sum(len(a[4]) for a in tables)} "
              f"pair_mask launches, masks copied back, np.nonzero) "
              f"{', '.join(f'{w * 1e3:.3f}' for w in walls['dense'])}, median {d:.3f}; "
              f"hyp_edges ({len(tables)} call{'s' * (len(tables) > 1)}) "
              f"{', '.join(f'{w * 1e3:.3f}' for w in walls['compact'])}, median {k:.3f}: "
              f"{d / k:.2f}x; the same hits in the same order ({card})")
        hosts = [host_table(a) for a in tables]
        _, d_groups, _ = profiled(lambda: [dense_route(t, dev) for t in hosts])
        _, k_groups, _ = profiled(lambda: [compact_route(t, dev) for t in hosts])
        print(f"  rhg_pe's adjacency at {what}, device ms under the profiler: the dense route "
              + (", ".join(f"{g} {v:.6f}" for g, v in sorted(d_groups.items())) or "not measured")
              + "; hyp_edges' route "
              + (", ".join(f"{g} {v:.6f}" for g, v in sorted(k_groups.items())) or "not measured")
              + " (copies and fills under other)")

    params = rhg.RHGParams(4096, 16.0, 2.6, 11)
    warm = []
    with timed_rhg_pe(warm):
        for _ in range(3):
            rhg.rhg_pe(params, 1, 0, device=dev)
            for pe in range(4):
                rhg.rhg_pe(params, 4, pe, device=dev)
    print(f"  rhg_pe walls, warm, 3 runs each (RHGParams(4096, 16, 2.6, 11)): "
          f"{rhg_pe_line(warm)}; graphs cold on path 3h: {rhg_pe_line(out['rhg_pe_cold'])}")

    # pair_mask's hyp tile at the largest segment, on the dense route's padded blocks
    big = max(seg.tolist(), key=lambda r: r[1] * r[3])
    qp, cp = padded_blocks(host_table(args), big, dev)
    res, ms, med = timed(lambda: pair_mask(qp, cp, cosh_r, tile="hyp"), reps=50,
                         label="pair_mask hyp, the largest segment of rhg_pe at P = 1")
    ref, plain_ms = sync_time(lambda: pair_mask_ref(qp, cp, cosh_r, tile="hyp"), reps=5)
    errs.same("pair_mask", res, ref, "pair_mask hyp at rhg_pe's largest segment")
    dense_dev = graph_ms_per_call(lambda: pair_mask(qp, cp, cosh_r, tile="hyp"), 50)
    dense_prof = device_ms_per_call(lambda: pair_mask(qp, cp, cosh_r, tile="hyp"), 50)
    d_bytes, d_ops = bound_terms(cost().pair_mask_hyp(qp.numel(), cp.numel(), res.numel()))
    d_bound = max(d_bytes, d_ops) * 1e3
    print(f"  pair_mask shape: hyp [{qp.shape[0]}, 8] x [{cp.shape[0]}, 8] float64 (the largest "
          f"of the {len(seg)} segments, padded); median {med:.6f} ms (mean {ms:.6f}; device "
          f"{dense_dev:.6f} ms a call by graph replay, {fmt_ms(dense_prof)} by the profiler), "
          f"plain {plain_ms:.6f} ms, bound {d_bound:.6f} ms "
          f"({'bytes' if d_bytes >= d_ops else 'operations'}): {dense_dev / d_bound:.2f}x the "
          f"bound by device time; no main path launches it")
    return [("hyp_edges", "src/repro_torch/kernels/pairmask/csrc/pairmask.cu",
             "src/repro/kernels/pairmask/pairmask.py:56", h_ms, h_med, h_plain, bytes_s, ops_s,
             None, f"rhg_pe's table at P = 1 on path 3h: {len(seg)} segments, {pairs} pairs, "
                   f"{hits} hits; device {dev_ms:.6f} ms by graph replay"),
            ("pair_mask", "src/repro_torch/kernels/pairmask/csrc/pairmask.cu",
             "src/repro/kernels/pairmask/pairmask.py:56", ms, med, plain_ms, d_bytes, d_ops,
             None, f"hyp tile at rhg_pe's largest segment, [{qp.shape[0]}, 8] x "
                   f"[{cp.shape[0]}, 8] float64, on the dense route's padded blocks (no "
                   f"main path launches it)")]


# optimizer of path 3i: the reference test's (lr 1e-3, warmup 5)
TRAIN_OPT = dict(lr=1e-3, warmup=5, total_steps=200)


def train_groups(key: str) -> str:
    """The training step's breakdown groups: the optimizer's multi-tensor
    kernels (``torch._foreach_*``) apart from :func:`lm_groups`' groups."""
    k = key.lower()
    if "multi_tensor" in k or "foreach" in k:
        return "optimizer elementwise"
    group = lm_groups(key)
    return "other" if group == "elementwise/other" else group


def train_smoke_archs(dev) -> None:
    """3i, part 1: the ten architectures at smoke size in float32, the
    same weights and batches on the card and on the CPU: one
    ``make_train_step`` step with ``accum=1``, then one with ``accum=2``,
    each held by the CPU tests' tolerances (``tests/torch_train_tol.py``:
    the loss, the grad norm, every updated master and ``m``)."""
    import copy
    import numpy as np
    import torch
    from torch_train_tol import GRAD_NORM_REL, LOSS_ABS, MOMENT_REL, PARAM_LR, step_errors
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  ten architectures at smoke size, float32, a train step with accum 1 then 2 on the "
          f"card against the CPU (bounds: loss {LOSS_ABS}, grad norm {GRAD_NORM_REL} of it, "
          f"masters {PARAM_LR} x lr, m {MOMENT_REL} of each leaf's max; errors below as shares "
          f"of them; {card_line()}):")
    opt_cfg = O.OptConfig(**TRAIN_OPT)
    for arch in ARCHS:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch)
        cpu = T.model_init(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        states = {"cpu": (cpu, O.opt_init(cpu))}
        card = copy.deepcopy(cpu).to(dev)
        states["card"] = (card, O.opt_init(card))
        rng = np.random.default_rng(1)
        line = f"  {arch:<22}"
        for accum in (1, 2):
            toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
            batch = {"positions": np.tile(np.arange(32, dtype=np.int32), (4, 1)),
                     "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)}
            if cfg.frontend != "none":
                batch["embeds"] = (rng.standard_normal((4, 32, cfg.d_model)) * 0.02
                                   ).astype(np.float32)
            else:
                batch["tokens"] = toks
            step = make_train_step(cfg, opt_cfg, accum=accum)
            out = {k: step(p, o, batch) for k, (p, o) in states.items()}
            states = {k: v[:2] for k, v in out.items()}
            (pc, oc, mc), (pg, og, mg) = out["cpu"], out["card"]
            try:
                e = step_errors(dict(pg.named_parameters()), og["m"], mg,
                                dict(pc.named_parameters()), oc["m"], mc)
            except AssertionError as err:
                raise AssertionError(f"chip_smoke: {arch} accum {accum}: the card's train step "
                                     f"differs from the CPU's: {err}") from None
            line += (f" accum {accum}: loss {float(mg['loss']):.6f} (cpu {float(mc['loss']):.6f})"
                     f" errors " + ", ".join(f"{k} {v:.3f}" for k, v in e.items()) + ";")
        print(line + f" ({time.perf_counter() - t0:.3f}s)")


def train_main(dev, sizes: dict, errs: Errors) -> dict:
    """3i, part 2: ``repro_torch.launch.train.main`` for Qwen3-0.6B at full
    width in bf16 (its data config: ``rhg_walk``, 4 x 256 a step, seed 11,
    the graph cold) for ``train_steps`` steps, checkpointed every
    ``train_ckpt_every`` in the background and at the end; each step timed
    on the host clock between ``synchronize`` calls, the ``hyp_edges``
    launch of the first batch's graph held against its plain version (and
    no ``pair_mask`` launch)."""
    import shutil
    import statistics
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import build
    from repro_torch.launch import cost as C
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.roofline import H100

    cfg = get_config(LM_ARCH)
    N, every = sizes["train_steps"], sizes["train_ckpt_every"]
    rec = {"step_s": [], "loss": [], "state": None}
    real = launch_train.make_train_step

    def timed_factory(arch_cfg, opt_cfg, **kw):
        step = real(arch_cfg, opt_cfg, **kw)

        def timed_step(params, opt, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            rec["loss"].append(out[2]["loss"])
            rec["state"] = out[:2]
            return out
        return timed_step

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    need = 2 * 12 * cfg.param_count()           # two checkpoints of masters, m and v
    require(shutil.disk_usage(ckpt).free > need, f"{shutil.disk_usage(ckpt).free / 1e9:.1f} "
            f"GB free under {ckpt}, main's checkpoints need {need / 1e9:.1f}")
    pipeline._local_graph.cache_clear()
    before = dict(build.LAUNCHES)
    launch_train.make_train_step = timed_factory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        with held_lm_kernels(errs) as held:
            code = launch_train.main(["--arch", LM_ARCH, "--steps", str(N), "--ckpt-every",
                                      str(every), "--ckpt-dir", ckpt, "--device", str(dev)])
        wall = time.perf_counter() - t0
        saved = sorted(os.listdir(ckpt))
    finally:
        launch_train.make_train_step = real
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    require(code == 0, f"launch/train.py main returned {code}")
    losses = [float(x) for x in rec["loss"]]
    require(len(losses) == N and all(math.isfinite(x) for x in losses),
            f"main ran {len(losses)} steps, losses {losses}")
    want = [f"step_{s:08d}" for s in sorted({s for s in range(every, N + 1, every)} | {N})]
    require(saved == want[-3:], f"checkpoints {saved}, expected {want[-3:]}")
    launches = build.LAUNCHES["hyp_edges"] - before["hyp_edges"]
    dense = build.LAUNCHES["pair_mask"] - before["pair_mask"]
    require(held.seen.get("hyp_edges", 0) == launches > 0 and dense == 0,
            f"hyp_edges: {launches} launches, {held.seen} held; pair_mask {dense} launches")
    steady = rec["step_s"][1:]
    med = statistics.median(steady)
    B, S = 4, 256
    tc = C.lm_train(cfg, B, S)
    bytes_s, ops_s = tc.seconds(H100)
    print(f"  launch/train.py main --arch {LM_ARCH} --steps {N} --ckpt-every {every} "
          f"({card_line()}): {wall:.3f}s wall, exit {code}; first batch's graph: {launches} "
          f"hyp_edges launch(es), each == hyp_edges_ref (max |err| {errs.max['hyp_edges']}), "
          f"{dense} pair_mask launches; "
          f"checkpoints {saved}")
    print(f"  train step, {cfg.dtype} over float32 masters, {B} x {S} tokens: first "
          f"{rec['step_s'][0] * 1e3:.3f} ms; after it median {med * 1e3:.3f} ms (min "
          f"{min(steady) * 1e3:.3f}, max {max(steady) * 1e3:.3f}; {len(steady)} steps, those "
          f"after step {every} beside the checkpoint's writing thread); {B * S / med:.1f} "
          f"tokens/s; {tc.ops / med / 1e12:.3f} TFLOP/s of model flops, "
          f"{100 * tc.ops / H100.ops_per_s('bf16') / med:.3f} % of the bf16 dense peak; "
          f"lm_train's bound {max(bytes_s, ops_s) * 1e3:.6f} ms by "
          f"{tc.bound_by(H100)} (bytes {bytes_s * 1e3:.6f} ms, bf16 operations "
          f"{ops_s * 1e3:.6f} ms): {med / max(bytes_s, ops_s):.1f}x it; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; losses {', '.join(f'{x:.4f}' for x in losses[::5])}")
    return {"state": rec["state"], "step_ms": med * 1e3, "first_ms": rec["step_s"][0] * 1e3,
            "peak_gib": peak / 2 ** 30, "hyp_edges_launches": launches}


def train_profile(dev, state, sizes: dict) -> None:
    """3i, part 3: on the trained state, the optimizer alone (``opt_update``
    on one step's gradients, CUDA events) and a few train steps under the
    profiler: device ms by group and the device's idle share."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    cfg = get_config(LM_ARCH)
    params, opt = state
    dc = launch_train.data_config(cfg)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipeline.make_global_batch(dc, 0, device=dev).items()}
    loss, _ = T.lm_loss(params, cfg, batch)
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del loss
    opt_cfg = O.OptConfig(**TRAIN_OPT)
    decay = O.weight_decay_names(cfg, params)
    n = sum(p.numel() for p in leaves)
    _, ms, med = timed(lambda: O.opt_update(opt_cfg, params, grads, opt, decay), reps=5,
                       label=f"opt_update at full width ({n:,} masters)")
    print(f"  optimizer alone: median {med:.6f} ms (mean {ms:.6f}); its seven float32 passes "
          f"over {n:,} masters {7 * 4 * n / 1e9:.3f} GB, bound "
          f"{7 * 4 * n / 3.35e12 * 1e3:.6f} ms at 3.35 TB/s ({card_line()})")
    del grads
    step = make_train_step(cfg, opt_cfg)
    k = sizes["train_profiled_steps"]

    def run():
        for _ in range(k):
            step(params, opt, batch)

    t0 = time.perf_counter()
    _, groups, wall = profiled(run, by=train_groups, cpu=False)
    print_breakdown(f"{k} train steps ({card_line()})", groups, wall)
    print(f"  [profiled steps and their reading {time.perf_counter() - t0:.3f}s]")


def train_overfit(dev, sizes: dict):
    """3i, part 4: Qwen3-0.6B at full width in bf16 from a seeded init,
    ``train_overfit_steps`` steps on one batch at lr 1e-3, warmup 5: the
    last loss below 0.7 x the first, every loss finite (the reference's
    ``test_loss_decreases_overfit``).  Returns ``[(params, opt)]``, the
    trained state in a list its taker empties, so that no frame holds it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    cfg = get_config(LM_ARCH)
    dc = launch_train.data_config(cfg)
    batch = pipeline.make_global_batch(dc, 0, device=dev)
    params = T.model_init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = O.opt_init(params)
    step = make_train_step(cfg, O.OptConfig(**TRAIN_OPT))
    t0 = time.perf_counter()
    losses = []
    for _ in range(sizes["train_overfit_steps"]):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    wall = time.perf_counter() - t0
    require(all(math.isfinite(x) for x in losses), f"overfit losses not finite: {losses}")
    require(losses[-1] < 0.7 * losses[0], f"overfit: last loss {losses[-1]} not below 0.7 x "
            f"the first {losses[0]}")
    print(f"  overfit one batch, {len(losses)} steps at lr 1e-3, warmup 5, {cfg.dtype} "
          f"({wall:.3f}s): losses {', '.join(f'{x:.4f}' for x in losses[::5])}, last "
          f"{losses[-1]:.4f} = {losses[-1] / losses[0]:.4f} x the first (must be < 0.7)")
    return [(params, opt)]


def train_accum(dev) -> None:
    """3i, part 5: float32 at full width from one seeded init: a step with
    ``accum=2`` against one with ``accum=1`` on the same batch, the masters
    within ``PARAM_LR`` x the step's learning rate (``tests/torch_train_tol.py``:
    the reference's own bound, 2e-5 at its first step's 2e-4, is 0.1 of
    it, set on a smoke model's 180 k masters; among 751.6 M, Adam turns
    the rounding of gradients near ``eps`` into up to 8 % of a step)."""
    import copy
    import torch
    from torch_train_tol import PARAM_LR
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH).replace(dtype="float32")
    dc = launch_train.data_config(cfg)
    batch = pipeline.make_global_batch(dc, 1, device=dev)
    t0 = time.perf_counter()
    p1 = T.model_init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    p2 = copy.deepcopy(p1)
    p1, _, m1 = make_train_step(cfg, O.OptConfig(**TRAIN_OPT), accum=1)(p1, O.opt_init(p1), batch)
    p2, _, m2 = make_train_step(cfg, O.OptConfig(**TRAIN_OPT), accum=2)(p2, O.opt_init(p2), batch)
    with torch.no_grad():
        d = max(float((a - b).abs().max()) for a, b in zip(p1.parameters(), p2.parameters()))
    dl = abs(float(m1["loss"]) - float(m2["loss"]))
    dg = abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) / float(m1["grad_norm"])
    bound = PARAM_LR * float(m1["lr"])
    require(d <= bound, f"accum=2 differs from accum=1 by {d} (bound {bound})")
    print(f"  float32 at full width, accum=2 against accum=1 on one batch ({card_line()}; "
          f"{time.perf_counter() - t0:.3f}s): masters max |diff| {d:.3e} = "
          f"{d / float(m1['lr']):.3e} x lr {float(m1['lr']):.3e} (bound {PARAM_LR} x lr, "
          f"{bound:.3e}), loss {float(m1['loss']):.6f} against "
          f"{float(m2['loss']):.6f} (|diff| {dl:.3e}), grad norm rel diff {dg:.3e}")
    del p1, p2
    torch.cuda.empty_cache()


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].detach() - b[k].detach()).abs().max()) for k in a)


def pack_leaves(tree) -> tuple:
    """A copy of every leaf of ``tree`` in one byte buffer on their device
    and its index ``[(name, offset, bytes, dtype, shape)]``: one CUDA IPC
    handle for a spawned process instead of one a leaf."""
    import torch
    from repro_torch.train import checkpoint as CK

    leaves = [(n, t.detach()) for n, t in CK.named_leaves(tree)]
    buf = torch.empty(sum(t.numel() * t.element_size() for _, t in leaves), dtype=torch.uint8,
                      device=leaves[0][1].device)
    index, off = [], 0
    for n, t in leaves:
        nb = t.numel() * t.element_size()
        buf[off:off + nb].view(t.dtype).copy_(t.reshape(-1))
        index.append((n, off, nb, str(t.dtype).split(".")[-1], tuple(t.shape)))
        off += nb
    return buf, index


def unpack_leaves(buf, index) -> dict:
    """``{name: view}`` of a :func:`pack_leaves` buffer."""
    import torch
    return {n: buf[off:off + nb].view(getattr(torch, dt)).view(shape)
            for n, off, nb, dt, shape in index}


def resume_child(cfg, dev_type: str, conn) -> None:
    """3i, part 6, in a fresh process (spawned): make a model and state of
    another seed on the card while the parent saves, and warm its step up
    on a batch of zeros (the restore replaces every leaf), then take ``(ckpt,
    saved, after, batches)`` from ``conn``; restore the checkpoint and hold
    it against ``saved`` (the parent's state at the save, packed, shared
    by CUDA IPC) bit for bit; run ``batches`` from it twice, from the
    restored state and from a copy of it, to measure the spread of
    repeating the steps; send the restore's seconds, the equality, that
    spread and the largest |difference| from ``after`` (the parent's
    uninterrupted run, packed)."""
    import copy
    import traceback
    try:
        import numpy as np
        import torch
        from repro_torch.models import transformer as T
        from repro_torch.train import checkpoint as CK
        from repro_torch.train import optimizer as O
        from repro_torch.train.train_loop import make_train_step

        dev = torch.device(dev_type)
        cuda = dev.type == "cuda"
        fresh = T.model_init(cfg, generator=torch.Generator(device=dev).manual_seed(1),
                             device=dev)
        like = {"params": fresh, "opt": O.opt_init(fresh)}
        step = make_train_step(cfg, O.OptConfig(**TRAIN_OPT))
        zeros = np.zeros((4, 256), np.int32)
        step(like["params"], like["opt"], {"tokens": zeros, "labels": zeros,
                                           "positions": zeros + np.arange(256, dtype=np.int32)})
        ready_at = time.perf_counter()      # CLOCK_MONOTONIC: the parent's clock too
        ckpt, saved, after, batches = conn.recv()
        saved, after = unpack_leaves(*saved), unpack_leaves(*after)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        CK.restore(ckpt, like)
        if cuda:
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = dict(CK.named_leaves(like))
        equal = set(got) == set(saved) and all(torch.equal(got[n], saved[n]) for n in saved)
        t0 = time.perf_counter()
        runs = []
        for params, opt in ((like["params"], like["opt"]),
                            (copy.deepcopy(like["params"]), copy.deepcopy(like["opt"]))):
            for b in batches:
                params, opt, _ = step(params, opt, b)
            runs.append(dict(CK.named_leaves({"params": params, "opt": opt})))
        res = {"restore_s": restore_s, "equal": equal, "leaves": len(got),
               "spread": _max_diff(runs[1], runs[0]), "resumed": _max_diff(runs[0], after),
               "ready_at": ready_at, "steps_s": time.perf_counter() - t0}
        del saved, after                            # release the parent's buffers first
        conn.send(res)
    except BaseException:
        conn.send({"error": traceback.format_exc()})
        raise
    finally:
        conn.close()


def train_checkpoint(dev, trained: list, sizes: dict) -> None:
    """3i, part 6: the trained state (9.0 GB: masters, ``m``, ``v``) saved
    with ``num_shards=4, background=True`` while 3 more steps run on it
    (the uninterrupted run); in a fresh process (:func:`resume_child`,
    spawned before the save), restored bit for bit equal to the state at
    the save, and the same 3 steps run from it twice: whether the card's
    step is deterministic, and the resumed run against the uninterrupted
    one, equal if it is, else within the spread of the two.  ``trained``
    holds the state (:func:`train_overfit`); it is taken out, so that the
    state's memory is free before the child's work."""
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    cfg = get_config(LM_ARCH)
    dc = launch_train.data_config(cfg)
    k = sizes["train_resume_steps"]
    batches = [pipeline.make_global_batch(dc, 100 + s, device=dev) for s in range(k)]
    step = make_train_step(cfg, O.OptConfig(**TRAIN_OPT))
    params, opt = trained.pop()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ctx = mp.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=resume_child, args=(cfg, dev.type, child_conn))
    t_child = time.perf_counter()
    child.start()                                   # its start-up overlaps the save
    child_conn.close()
    try:
        saved = pack_leaves({"params": params, "opt": opt})
        nbytes = saved[0].numel()
        free = shutil.disk_usage(ckpt).free
        require(free > 2 * nbytes, f"{free / 1e9:.1f} GB free under {ckpt}, the checkpoint "
                f"needs {nbytes / 1e9:.1f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th = CK.save(ckpt, 1, {"params": params, "opt": opt}, num_shards=4, background=True)
        snap_s = time.perf_counter() - t0
        for b in batches:                           # the uninterrupted run goes on
            params, opt, _ = step(params, opt, b)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0 - snap_s
        th.join()
        save_s = time.perf_counter() - t0
        live = pack_leaves({"params": params, "opt": opt})
        del params, opt, th
        torch.cuda.empty_cache()                    # room for the child's two states
        conn.send((ckpt, saved, live, batches))
        t_sent = time.perf_counter()
        try:
            res = conn.recv() if conn.poll(600) else {"error": "no answer in 600 s"}
        except EOFError:
            res = {"error": "the child closed its pipe without an answer"}
        answer_s = time.perf_counter() - t_sent
    finally:
        conn.close()                                # a child still waiting sees EOF
        child.join(60)
        if child.is_alive():
            child.kill()
            child.join()
        shutil.rmtree(ckpt, ignore_errors=True)
    child_s = time.perf_counter() - t_child
    require("error" not in res and child.exitcode == 0,
            f"the resume in a fresh process failed (exit {child.exitcode}): {res.get('error')}")
    require(res["equal"], "the state restored in a fresh process differs from the state at "
            "the save")
    restore_s, spread, resumed = res["restore_s"], res["spread"], res["resumed"]
    print(f"  checkpoint of the trained state ({nbytes / 1e9:.3f} GB, 4 shards, in the "
          f"background; {card_line()}): host copy {snap_s:.3f}s, then {k} steps in "
          f"{steps_s:.3f}s while it wrote, written in {save_s:.3f}s ({nbytes / save_s / 1e9:.3f} "
          f"GB/s); in a fresh process (ready {res['ready_at'] - t_child:.3f}s after its spawn, "
          f"beside the save; answered {answer_s:.3f}s after the save; {child_s:.3f}s from spawn to exit), "
          f"restored into a model and state of another seed in {restore_s:.3f}s "
          f"({nbytes / restore_s / 1e9:.3f} GB/s, the files read warm from the page cache): "
          f"bit for bit the state at the save ({res['leaves']} leaves); its {2 * k} steps and "
          f"comparisons {res['steps_s']:.3f}s")
    if spread == 0:
        require(resumed == 0, f"the card's step is deterministic, but the resumed run differs "
                f"from the uninterrupted one by {resumed}")
    else:
        require(resumed <= spread, f"the resumed run differs from the uninterrupted one by "
                f"{resumed}, past the spread of repeating the steps, {spread}")
    print(f"  {k} steps twice from the restored state: max |diff| {spread:.3e} "
          f"({'deterministic' if spread == 0 else 'not deterministic'}); against the "
          f"uninterrupted run: max |diff| {resumed:.3e}"
          f"{' (equal, as required)' if spread == 0 else ''}")
    del saved, live
    torch.cuda.empty_cache()


def phase_train(dev, sizes: dict) -> dict:
    """Phase 3i: training (``--only train``): the ten architectures' train
    step on the card against the CPU, then Qwen3-0.6B at full width:
    ``launch/train.py``'s main timed, the optimizer and a profiled step,
    overfitting one batch, accumulation in float32, a checkpoint's round
    trip and resume."""
    import torch

    errs = Errors()
    t0 = time.perf_counter()
    train_smoke_archs(dev)
    print(f"  [3i smoke architectures {time.perf_counter() - t0:.3f}s]", flush=True)
    t1 = time.perf_counter()
    out = train_main(dev, sizes, errs)
    print(f"  [3i main {time.perf_counter() - t1:.3f}s]", flush=True)
    t1 = time.perf_counter()
    train_profile(dev, out.pop("state"), sizes)
    torch.cuda.empty_cache()
    print(f"  [3i optimizer and profile {time.perf_counter() - t1:.3f}s]", flush=True)
    t1 = time.perf_counter()
    trained = train_overfit(dev, sizes)
    print(f"  [3i overfit {time.perf_counter() - t1:.3f}s]", flush=True)
    t1 = time.perf_counter()
    train_checkpoint(dev, trained, sizes)
    print(f"  [3i checkpoint {time.perf_counter() - t1:.3f}s]", flush=True)
    t1 = time.perf_counter()
    train_accum(dev)
    print(f"  [3i accumulation {time.perf_counter() - t1:.3f}s]", flush=True)
    out["errs"] = errs
    return out


def train_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of 3i: no kernel of its own (the step is cuBLAS and ATen);
    its ``hyp_edges`` launch joins the kernel's row of path 3h."""
    errs.max["hyp_edges"] = max(errs.max["hyp_edges"], out["errs"].max["hyp_edges"])
    return []


MESH_DRYRUNS = (("train_4k", False), ("decode_32k", False))
# the calibration step: path 3i's, 4 x 256 tokens in bf16 over float32 masters
MESH_CALIBRATION = {"batch": 4, "seq": 256}
# the dry run's peak against the step's own allocations on the card: on an
# H100 80GB HBM3 the sound model read -0.41 %, and a dry run that lost the
# 2.8 GiB of float32 masters -17 %
MESH_PEAK_REL = 0.03


def roofline_line(rec: dict) -> str:
    """One dry-run record as a line: peak, per-device counts and the
    roofline terms (computed from the H100's data-sheet rates)."""
    r, d = rec["roofline"], rec["per_device"]
    peak = rec.get("memory", {}).get("peak_per_device")
    colls = ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e9:.3f} GB"
                      for k, v in rec.get("collectives", {}).items()) or "none"
    return (f"{rec['arch']} {rec['shape']} on {rec['chips']} ranks"
            f"{' (multi-pod)' if rec['multi_pod'] else ''}: "
            + (f"peak {peak / 1e9:.3f} GB a device, " if peak else "")
            + f"{d['flops']:.6e} flops, {d['bytes']:.6e} bytes, {d['collective_bytes']:.6e} "
            f"collective bytes a device ({colls}); roofline from H100 data-sheet rates: compute "
            f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, collective "
            f"{r['collective_s']:.6f} s, {rec['dominant']}"
            + (f"; useful-flops ratio {rec['useful_flops_ratio']:.4f}"
               if rec.get("useful_flops_ratio") else ""))


def mesh_calibration(dev) -> dict:
    """3j, part 2: the dry run of Qwen3-0.6B on a (1, 1) mesh at path 3i's
    step against that step run on the card: the predicted peak within
    ``MESH_PEAK_REL`` of ``max_memory_allocated`` less what was allocated
    before the model was made (what earlier paths left), and the matmul
    flops equal to ``FlopCounterMode``'s."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step

    cfg = get_config(LM_ARCH)
    B, S = MESH_CALIBRATION["batch"], MESH_CALIBRATION["seq"]
    spec = ShapeSpec("train_3i", "train", S, B)
    t0 = time.perf_counter()
    try:
        _, _, cost = dryrun.run_step(LM_ARCH, spec, M.make_debug_mesh(1, 1), cfg=cfg)
    finally:
        M.reset()
    dry_s = time.perf_counter() - t0
    require(not cost.collectives, f"a (1, 1) dry run issued collectives {cost.collectives}")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "positions": np.tile(np.arange(S, dtype=np.int32), (B, 1))}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = T.model_init(cfg, device=dev)
    opt = O.opt_init(params)
    step = make_train_step(cfg, O.OptConfig())
    step(params, opt, batch)                 # cuBLAS handles and workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    out = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(out[2]["loss"])
    del out
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    flops = fc.get_total_flops()
    del params, opt
    torch.cuda.empty_cache()
    pred, pred_flops = cost.peak_bytes, cost.flops_by.get("matmul", 0)
    rel = (pred - peak) / peak
    print(f"  calibration ({card_line()}): {LM_ARCH} at full width, path 3i's step ({B} x {S} "
          f"tokens, {cfg.dtype} over float32 masters, remat), dry run on a (1, 1) mesh "
          f"({dry_s:.3f}s) against the step on the card ({step_s * 1e3:.3f} ms, loss "
          f"{loss:.4f}): peak predicted {pred} bytes ({pred / 2 ** 30:.3f} GiB), measured "
          f"max_memory_allocated less {base} bytes left by earlier paths {peak} bytes "
          f"({peak / 2 ** 30:.3f} GiB; {(held - base) / 2 ** 30:.3f} GiB of it held before the "
          f"step), {100 * rel:+.2f} %; matmul flops predicted {pred_flops}, "
          f"FlopCounterMode {flops}; all flops predicted {cost.flops:.6e} (elementwise "
          f"{cost.flops_by.get('elementwise', 0):.6e}, reduce {cost.flops_by.get('reduce', 0):.6e}),"
          f" bytes {cost.bytes:.6e}")
    require(math.isfinite(loss), f"the calibration step's loss is {loss}")
    require(abs(rel) <= MESH_PEAK_REL, f"the dry run's peak {pred} is {100 * rel:+.2f} % off "
            f"the card's {peak}, past {100 * MESH_PEAK_REL:.0f} %")
    require(pred_flops == flops, f"the dry run's matmul flops {pred_flops} != the card's {flops}")
    return {"pred_peak": pred, "peak": peak, "flops": flops}


def mesh_smoke_4x2() -> dict:
    """3j, part 3: the prefill and decode dry runs of Qwen3's smoke config
    on a fake (4, 2) mesh (a batch of 8, 64 positions): the kv heads and
    the cache's positions are sharded over the model axis, which the
    decode attention (``models/layers.py::_sdpa_decode``) must take on
    this torch's DTensor.  Each record's status must be ``ok``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M

    cfg = get_smoke_config(LM_ARCH)
    recs = {}
    try:
        M.reset()
        mesh = M.make_debug_mesh(4, 2)
        for spec in (ShapeSpec("prefill_smoke", "prefill", 64, 8),
                     ShapeSpec("decode_smoke", "decode", 64, 8)):
            rec = dryrun.run_cell(LM_ARCH, spec.name, False, mesh=mesh, cfg=cfg, spec=spec)
            require(rec["status"] == "ok", f"the (4, 2) smoke {spec.kind}: {rec}")
            recs[spec.kind] = rec
    finally:
        M.reset()
    return recs


def phase_mesh(dev, sizes: dict) -> dict:
    """Phase 3j: the LM's meshes and dry run (``--only mesh``): the dry
    runs of Qwen3-0.6B at ``train_4k`` and ``decode_32k`` on the fake
    16 x 16 mesh (``python -m repro_torch.launch.dryrun`` in two
    processes, on the host, while the rest runs); the dry run at path 3i's
    step on a (1, 1) mesh against the card's step; the generator cell
    (``GNM(2^30, 2^34)``, PE 0's program on the card under the op scan, no
    collective, each launch held against its plain version) at 256 and
    512 ranks."""
    import tempfile
    import torch
    from repro_torch.launch import dryrun

    errs = Errors()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    t0 = time.perf_counter()
    for shape, mp in MESH_DRYRUNS:
        out = os.path.join(outdir, f"{LM_ARCH}.{shape}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH,
               "--shape", shape, "--out", out] + (["--multi-pod"] if mp else [])
        procs.append((shape, out, subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                                   stderr=subprocess.PIPE, text=True)))
    try:
        t1 = time.perf_counter()
        cal = mesh_calibration(dev)
        print(f"  [3j calibration {time.perf_counter() - t1:.3f}s]", flush=True)
        t1 = time.perf_counter()
        smoke = mesh_smoke_4x2()
        for kind, rec in smoke.items():
            print(f"  (4, 2) smoke {kind} (the two dry runs {time.perf_counter() - t1:.3f}s on "
                  f"the host, torch {torch.__version__}): {roofline_line(rec)}", flush=True)
        gens = []
        for mp in (False, True):
            t1 = time.perf_counter()
            # every launch held against its plain version at the cell's own
            # shapes (PE 0's one row of 2^25 or 2^26 slots)
            with held_kernels(errs, f"3j generator cell{' (multi-pod)' if mp else ''}") as held:
                rec = dryrun.run_generator_cell(mp, n=sizes["mesh_gen_n"],
                                                m=sizes["mesh_gen_m"], device=dev)
            require(held.seen == rec["launches"], f"generator cell: held {held.seen} calls, "
                    f"the op scan counted {rec['launches']} launches")
            want = rec["edges_pe0_plan"]
            require(rec["edges_pe0"] == want, f"generator cell: PE 0 gave {rec['edges_pe0']} "
                    f"edges, its plan {want}")
            print(f"  generator cell ({time.perf_counter() - t1:.3f}s, {card_line()}): "
                  f"{roofline_line(rec)}; PE 0: {rec['edges_pe0']} edges, launches "
                  f"{rec['launches']}, each == its plain version (max |err| chunk_sample "
                  f"{errs.max['chunk_sample']}, chunk_decode {errs.max['chunk_decode']}), no "
                  f"collective in its op scan", flush=True)
            gens.append(rec)
        recs = []
        for shape, out, proc in procs:
            _, err = proc.communicate(timeout=600)
            require(proc.returncode == 0, f"dry run of {LM_ARCH} {shape} exited "
                    f"{proc.returncode}: {err[-2000:]}")
            with open(out) as f:
                rec = json.load(f)
            require(rec["status"] == "ok" and rec["memory"]["peak_per_device"] > 0
                    and rec["per_device"]["flops"] > 0, f"dry run record {rec}")
            print(f"  dry run ({rec['run_s']}s on the host): {roofline_line(rec)}")
            recs.append(rec)
        print(f"  [3j dry runs, joined at {time.perf_counter() - t0:.3f}s]", flush=True)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil
        shutil.rmtree(outdir, ignore_errors=True)
    return {"calibration": cal, "dryruns": recs, "generator": gens, "errs": errs}


def mesh_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of 3j: no kernel of its own; the generator cell's
    ``chunk_sample``/``chunk_decode`` launches, each held against its plain
    version, join those kernels' counts and errors."""
    for k in MESH_KERNELS:
        errs.max[k] = max(errs.max[k], out["errs"].max[k])
    return []


WORLD_RANKS = 4
WORLD_P = 16
# each rank holds its first launch of these against their plain versions
# (chunk_rmat's plain version at rmat_pe's 2^26 slots takes 13 GiB a rank)
WORLD_HELD = ("chunk_sample", "chunk_decode", "pair_edges")


def world_specs(api, sizes: dict) -> dict:
    """Path 3k's specs: the main paths' GNM (generated), SBM, RHG and an
    RDG of 2^16 points (streamed), and the shapes of the per-PE
    generators' one-process counterparts (streamed)."""
    return {"gnm": api.GNM(n=sizes["gnm_n"], m=sizes["gnm_m"], seed=1),
            "sbm": api.SBM(n=sizes["sbm_n"], blocks=sizes["sbm_blocks"],
                           p_in=sizes["sbm_p"][0], p_out=sizes["sbm_p"][1], seed=10),
            "rhg": api.RHG(n=sizes["rhg_n"], avg_deg=16, gamma=2.8, seed=5),
            "rdg": api.RDG(n=sizes["world_rdg_n"], dim=2, seed=6),
            "gnm_directed_pe": api.GNM(n=sizes["gnm_n"], m=sizes["gnm_m"], directed=True,
                                       seed=1),
            "rmat_pe": api.RMAT(log_n=sizes["rmat_log_n"], m=sizes["rmat_m"], seed=8)}


def small_generators(n: int) -> dict:
    """The per-PE generators at a size whose plain versions finish in
    seconds: name -> ``fn(pe, device)`` at P = ``WORLD_P``."""
    from repro_torch.core import ba, er, rmat, sbm
    P, log_n = WORLD_P, n.bit_length() - 1
    return {
        "gnm_directed_pe": lambda pe, dev: er.gnm_directed_pe(3, n, 16 * n, P, pe, device=dev),
        "gnp_directed_pe": lambda pe, dev: er.gnp_directed_pe(4, n, 16 / n, P, pe, device=dev),
        "gnp_undirected_pe": lambda pe, dev: er.gnp_undirected_pe(5, n, 16 / n, P, pe,
                                                                  device=dev),
        "gnm_undirected_pe": lambda pe, dev: torch_of(
            er.gnm_undirected_pe(9, n, 8 * n, P, pe, device=dev), dev),
        "ba_pe": lambda pe, dev: ba.ba_pe(6, n, 8, P, pe, device=dev),
        "rmat_pe": lambda pe, dev: rmat.rmat_pe(7, log_n, 16 * n, P, pe, device=dev),
        "sbm_pe": lambda pe, dev: sbm.sbm_pe(8, n, 16, 2 ** -9, 2 ** -13, P, pe, device=dev),
        "sbm_region_edges": lambda pe, dev: sbm.sbm_region_edges(8, n, 16, pe, pe // 2,
                                                                 2 ** -9, 2 ** -13, device=dev),
    }


def torch_of(a, dev):
    import torch
    return torch.from_numpy(a).to(dev)


class Digests:
    """Per-PE ``(edges, digest)``: a PE's digest is the wrapping int64 sum
    of a mix of each edge with its position in that PE's output, so it
    holds the per-PE order; chunks of a PE are added in order."""

    def __init__(self):
        self.n, self.h = {}, {}

    def add(self, pe: int, e) -> None:
        import torch
        k, at = len(e), self.n.get(pe, 0)
        self.n[pe] = at + k
        self.h.setdefault(pe, 0)
        if k:
            pos = torch.arange(at + 1, at + k + 1, device=e.device)
            h = (e[:, 0] * _MIX1 + e[:, 1]) ^ (pos * _POS)
            h = (h ^ (h >> 31)) * _MIX2
            self.h[pe] = (self.h[pe] + int((h ^ (h >> 29)).sum())) % (1 << 64)

    def split(self, edges, counts, lo: int) -> "Digests":
        """Add ``edges`` cut into PEs ``lo, lo + 1, ...`` of ``counts`` edges."""
        at = 0
        for i, k in enumerate(counts):
            self.add(lo + i, edges[at:at + int(k)])
            at += int(k)
        require(at == len(edges), f"{len(edges)} edges, the plan's PEs hold {at}")
        return self

    def of(self, pe: int) -> tuple:
        return self.n.get(pe, 0), self.h.get(pe, 0)


def owned_counts(plan):
    """Each PE's edge count of a ChunkPlan (its owned rows')."""
    return (plan.count * plan.owned).sum(axis=1)


def world_rank(rank: int, size: int, sizes: dict, conn) -> None:
    """Path 3k, one rank of the world (spawned): ``World.from_env()`` from
    torchrun's variables, then the rank's own PEs of ``world_specs``
    (its PEs' ``gnm_directed_pe`` and ``rmat_pe`` under an op trace;
    ``generate`` of GNM; SBM, RHG and RDG streamed, with ``check=True``),
    the first launch of each kernel of ``WORLD_HELD`` held against its
    plain version; then the small per-PE generators.  Sends per-PE digests, walls, launches, errors and
    the op scan's collectives to the parent."""
    import traceback
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
        import torch
        from repro_torch import api
        from repro_torch.analyze import opscan
        from repro_torch.core import er, rmat
        from repro_torch.distrib import runtime
        from repro_torch.distrib.world import World
        from repro_torch.kernels import build

        t_start = time.perf_counter()
        world = World.from_env()
        dev = world.bind()
        torch.empty(1, device=dev)
        lo, hi = world.pes(WORLD_P)
        specs = world_specs(api, sizes)
        build.reset_launches()
        errs, walls, dig = Errors(), {}, {k: Digests() for k in specs}
        ready = time.perf_counter()
        with held_kernels(errs, f"rank {rank}", first_only=True, names=WORLD_HELD) as held:
            # first, so that the sampler's first launch, held against its
            # plain version, is one row of 2^24 slots a PE
            gd, rm = specs["gnm_directed_pe"], specs["rmat_pe"]
            t0 = time.perf_counter()
            with opscan.trace() as census:
                for pe in range(lo, hi):
                    dig["gnm_directed_pe"].add(pe, er.gnm_directed_pe(
                        gd.seed, gd.n, gd.m, WORLD_P, pe, device=dev))
                    dig["rmat_pe"].add(pe, rmat.rmat_pe(
                        rm.seed, rm.log_n, rm.m, WORLD_P, pe, rm.probs, device=dev))
            torch.cuda.synchronize()
            walls["per-PE generators"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            g = api.generate(specs["gnm"], WORLD_P, mesh=world, check=True)
            counts = owned_counts(specs["gnm"].plan(WORLD_P))[lo:hi]
            dig["gnm"].split(g.edges, counts, lo)
            del g
            torch.cuda.synchronize()
            walls["gnm generate"] = time.perf_counter() - t0
            for name in ("sbm", "rhg", "rdg"):
                t0 = time.perf_counter()
                for ch in api.iter_edge_chunks(specs[name], WORLD_P, mesh=world,
                                               batch=sizes["batch"], check=True):
                    dig[name].add(ch.pe, ch.edges())
                torch.cuda.synchronize()
                walls[f"{name} stream"] = time.perf_counter() - t0
        wall = time.perf_counter() - ready
        scanned = sorted(f"{k[0]}/{k[1][0]}" for k in runtime._CHECKED)
        collectives = opscan.scan_census(census, opscan.GENERATOR_CONTRACT).collectives
        small = {}
        for name, fn in small_generators(sizes["world_small_n"]).items():
            d = Digests()
            for pe in range(lo, hi):
                d.add(pe, fn(pe, dev))
            small[name] = {pe: d.of(pe) for pe in range(lo, hi)}
        conn.send({"rank": rank, "pes": (lo, hi), "device": str(dev),
                   "startup_s": ready - t_start, "wall": wall, "walls": walls,
                   "plain_s": held.plain_s, "held": held.seen, "errs": errs.max,
                   "launches": dict(build.LAUNCHES), "scanned": scanned,
                   "collectives": collectives,
                   "digests": {k: {pe: d.of(pe) for pe in range(lo, hi)}
                               for k, d in dig.items()},
                   "small": small})
    except BaseException:
        conn.send({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        conn.close()


# a world of ranks that own several rows each: its ranks and rows a rank
CARD_RANKS, CARD_ROWS = 2, 2


def world_cards_rank(rank: int, size: int, sizes: dict, conn) -> None:
    """Path 3k, one rank of a world whose ranks own ``CARD_ROWS`` rows each
    (spawned): ``World.from_env(cards=CARD_ROWS)`` (every row on this
    machine's one card, a stream each), ``generate`` of GNM and the SBM
    stream on the rank's PEs without the contract scan (path 3l scans
    each row's programs on the card, and a fresh process's first checked
    run takes about ten seconds), each row's first
    ``chunk_decode`` launch held (its first ``chunk_sample``, whose plain
    version at a row of 2^24 slots takes seconds and gigabytes, is held
    on path 3l's rows and the world of four).  Sends per-PE digests,
    walls, held launches, errors and launches."""
    import traceback
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(size))
        import torch
        from repro_torch import api
        from repro_torch.distrib.world import World
        from repro_torch.kernels import build

        t_start = time.perf_counter()
        world = World.from_env(cards=CARD_ROWS)
        dev = world.bind()
        torch.empty(1, device=dev)
        lo, hi = world.pes(WORLD_P)
        specs = world_specs(api, sizes)
        build.reset_launches()
        errs, walls, dig = Errors(), {}, {k: Digests() for k in ("gnm", "sbm")}

        def row_of():
            return torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream

        ready = time.perf_counter()
        with held_kernels(errs, f"rank {rank} of {CARD_ROWS} rows", first_only=True,
                          names=("chunk_decode",), per=row_of) as held:
            t0 = time.perf_counter()
            g = api.generate(specs["gnm"], WORLD_P, mesh=world, check=False)
            require(g.edges.device == world.device, f"rank {rank}: edges on {g.edges.device}")
            dig["gnm"].split(g.edges, owned_counts(specs["gnm"].plan(WORLD_P))[lo:hi], lo)
            del g
            torch.cuda.synchronize()
            walls["gnm generate"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for ch in api.iter_edge_chunks(specs["sbm"], WORLD_P, mesh=world,
                                           batch=sizes["batch"]):
                dig["sbm"].add(ch.pe, ch.edges())
            torch.cuda.synchronize()
            walls["sbm stream"] = time.perf_counter() - t0
        conn.send({"rank": rank, "pes": (lo, hi), "rows": world.row_range(),
                   "devices": [str(d) for d in world.devices], "startup_s": ready - t_start,
                   "wall": time.perf_counter() - ready, "walls": walls,
                   "plain_s": held.plain_s, "held": held.seen, "errs": errs.max,
                   "launches": dict(build.LAUNCHES),
                   "digests": {k: {pe: d.of(pe) for pe in range(lo, hi)}
                               for k, d in dig.items()}})
    except BaseException:
        conn.send({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        conn.close()


def spawn(target, ranks: int, sizes: dict) -> tuple:
    """Start ``target(rank, ranks, sizes, conn)`` in ``ranks`` spawned
    processes; ``(processes, pipes, start time)`` for :func:`gather`."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs, conns = [], []
    t0 = time.perf_counter()
    for r in range(ranks):
        conn, child = ctx.Pipe()
        p = ctx.Process(target=target, args=(r, ranks, sizes, child))
        p.start()
        child.close()
        procs.append(p)
        conns.append(conn)
    return procs, conns, t0


def gather(started) -> tuple:
    """``(each rank's result, seconds from spawn to the last result)`` of
    a :func:`spawn`, requiring every rank to succeed and exit 0; every
    process is ended either way."""
    procs, conns, t0 = started
    out = []
    try:
        for conn in conns:
            res = conn.recv()
            require("error" not in res, f"world rank failed:\n{res.get('error')}")
            out.append(res)
        done = time.perf_counter() - t0
        for p in procs:
            p.join(timeout=120)
            require(p.exitcode == 0, f"a world rank exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return out, done


def world_cards(ranks: list, world_s: float, one: dict, errs: Errors) -> float:
    """Path 3k's world of ``CARD_RANKS`` ranks of ``CARD_ROWS`` rows each
    (``ranks``, their results), all on this card: every rank's per-PE
    digests of GNM and the SBM stream against the one process's, every
    row's first launches held.  Returns the world's wall (the slowest
    rank)."""
    from repro_torch.kernels import build

    for res in ranks:
        r, (lo, hi) = res["rank"], res["pes"]
        require(tuple(res["rows"]) == (r * CARD_ROWS, (r + 1) * CARD_ROWS),
                f"rank {r} holds rows {res['rows']}")
        for name, d in res["digests"].items():
            for pe in range(lo, hi):
                require(d[pe] == one[name].of(pe), f"rank {r} of {CARD_ROWS} rows, {name}, PE "
                        f"{pe}: digest {d[pe]} != the one process's {one[name].of(pe)}")
        require(res["held"].get("chunk_decode") == CARD_ROWS, f"rank {r}: chunk_decode held "
                f"on {res['held'].get('chunk_decode')} of its {CARD_ROWS} rows")
        for k, v in res["errs"].items():
            errs.max[k] = max(errs.max[k], v)
        for k, v in res["launches"].items():
            build.LAUNCHES[k] += v
        print(f"  rank {r} of {CARD_RANKS}, rows {res['rows']} on {res['devices']}, PEs "
              f"[{lo}, {hi}): wall {res['wall']:.3f}s (plain versions {res['plain_s']:.3f}s; "
              f"start-up {res['startup_s']:.3f}s before it): " + ", ".join(
                  f"{k} {v:.3f}s" for k, v in res["walls"].items())
              + f"; first launches held {res['held']}", flush=True)
    slowest = max(res["wall"] for res in ranks)
    print(f"  world of {CARD_RANKS} ranks x {CARD_ROWS} rows ({card_line()}), P = {WORLD_P}: "
          f"world wall (the slowest rank) {slowest:.3f}s, spawn to the last result "
          f"{world_s:.3f}s; every per-PE digest of GNM and the SBM stream == the one "
          f"process's; every row on the one card: correctness, not scaling", flush=True)
    return slowest


def world_one_process(dev, specs: dict, sizes: dict) -> tuple:
    """The same specs at P = 16 in this one process on the card: per-PE
    digests (GNM generated and cut by its plan's counts; the others
    streamed) and the wall of each."""
    import torch
    from repro_torch import api
    from repro_torch.core import rdg

    rdg.rdg_structure.cache_clear()         # cold, as on every rank
    dig, walls = {k: Digests() for k in specs}, {}
    t0 = time.perf_counter()
    g = api.generate(specs["gnm"], WORLD_P, device=dev)
    dig["gnm"].split(g.edges, owned_counts(specs["gnm"].plan(WORLD_P)), 0)
    del g
    torch.cuda.synchronize()
    walls["gnm generate"] = time.perf_counter() - t0
    for name in ("sbm", "rhg", "rdg", "gnm_directed_pe", "rmat_pe"):
        t0 = time.perf_counter()
        for ch in api.iter_edge_chunks(specs[name], WORLD_P, device=dev, batch=sizes["batch"]):
            dig[name].add(ch.pe, ch.edges())
        torch.cuda.synchronize()
        walls[f"{name} stream"] = time.perf_counter() - t0
    return dig, walls


def phase_world(dev, sizes: dict) -> dict:
    """Phase 3k: generation across ranks (``--only world``).  A world of
    ``WORLD_RANKS`` spawned ranks, every one on this card (``cuda:0``),
    no process group: each rank generates its own PEs of ``world_specs``
    at P = 16 (:func:`world_rank`) while this process runs the small
    per-PE generators on the CPU; then the same specs in this one
    process.  Every per-PE digest of a rank must equal the one process's,
    the small generators' card digests their CPU digests, every rank's
    op scan must find no collective and every rank's first
    ``chunk_sample``, ``chunk_decode`` and ``pair_edges`` launch must
    equal its plain version.  Then a world of ``CARD_RANKS`` ranks of
    ``CARD_ROWS`` rows each (:func:`world_cards`) against the same one
    process.  Ranks and rows sharing one card measure correctness, not
    scaling."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    torch.cuda.empty_cache()                # the earlier paths' cache, for the ranks
    # this process runs the small generators on the CPU while the ranks work
    cpu, cpu_s = {}, [0.0]

    def small_on_cpu():
        t1 = time.perf_counter()
        for name, fn in small_generators(sizes["world_small_n"]).items():
            d = Digests()
            for pe in range(WORLD_P):
                d.add(pe, fn(pe, "cpu"))
            cpu[name] = d
        cpu_s[0] = time.perf_counter() - t1

    started = spawn(world_rank, WORLD_RANKS, sizes)
    try:
        small_on_cpu()
    finally:
        ranks, world_s = gather(started)
    cpu_s = cpu_s[0]
    specs = world_specs(api, sizes)
    t1 = time.perf_counter()
    one, one_walls = world_one_process(dev, specs, sizes)
    one_s = time.perf_counter() - t1
    errs = Errors()
    for res in ranks:
        r, (lo, hi) = res["rank"], res["pes"]
        for name in specs:
            for pe in range(lo, hi):
                require(res["digests"][name][pe] == one[name].of(pe),
                        f"rank {r}, {name}, PE {pe}: digest {res['digests'][name][pe]} != "
                        f"the one process's {one[name].of(pe)}")
        for name, d in res["small"].items():
            for pe in range(lo, hi):
                require(d[pe] == cpu[name].of(pe), f"rank {r}, {name}({pe}) on the card "
                        f"{d[pe]} != on the CPU {cpu[name].of(pe)}")
        require(not res["collectives"], f"rank {r}'s op scan found {res['collectives']}")
        for k in WORLD_HELD:
            require(res["held"].get(k) == 1, f"rank {r}: {k}'s first launch was not held")
        for k, v in res["errs"].items():
            errs.max[k] = max(errs.max[k], v)
        for k, v in res["launches"].items():
            build.LAUNCHES[k] += v
        less = res["wall"] - res["plain_s"]
        print(f"  rank {r} of {WORLD_RANKS} on {res['device']}, PEs [{lo}, {hi}): wall "
              f"{res['wall']:.3f}s ({less:.3f}s less the plain versions' "
              f"{res['plain_s']:.3f}s; start-up {res['startup_s']:.3f}s before it): "
              + ", ".join(f"{k} {v:.3f}s" for k, v in res["walls"].items())
              + f"; programs scanned {len(res['scanned'])}, collectives none; first "
              f"launches held {res['held']}, max |err| " + ", ".join(
                  f"{k} {res['errs'][k]}" for k in WORLD_HELD)
              + f"; launches {({k: v for k, v in res['launches'].items() if v})}", flush=True)
    edges = {k: sum(d.of(pe)[0] for pe in range(WORLD_P)) for k, d in one.items()}
    slowest = max(res["wall"] for res in ranks)
    print(f"  world ({card_line()}): {WORLD_RANKS} ranks sharing the one card, P = {WORLD_P}: "
          f"world wall (the slowest rank) {slowest:.3f}s, spawn to the last result "
          f"{world_s:.3f}s; one process {one_s:.3f}s (" + ", ".join(
              f"{k} {v:.3f}s" for k, v in one_walls.items()) + "); four ranks on one card "
          f"measure correctness, not scaling", flush=True)
    print(f"  every per-PE digest of the ranks == the one process's, "
          f"{len(specs) * WORLD_P} PEs x specs: " + ", ".join(
              f"{k} {v} edges" for k, v in edges.items())
          + f"; small per-PE generators (n = {sizes['world_small_n']}) on the card == on the "
          f"CPU ({cpu_s:.3f}s there): " + ", ".join(
              f"{k} {sum(d.of(pe)[0] for pe in range(WORLD_P))}" for k, d in cpu.items()),
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cards_s = world_cards(*gather(spawn(world_cards_rank, CARD_RANKS, sizes)), one, errs)
    return {"errs": errs, "ranks": ranks, "one_s": one_s, "world_s": slowest,
            "cards_s": cards_s}


def world_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of 3k: no kernel of its own; each rank's first launches,
    held against their plain versions, join those kernels' errors."""
    for k in WORLD_KERNELS:
        errs.max[k] = max(errs.max[k], out["errs"].max[k])
    return []


LOCAL_ROWS = 4
LOCAL_P = 16
# the local mesh's rows sample and decode (GNM, SBM, the fleet's chunk
# slabs) and test pairs (RHG, the fleet's pair slabs), and its collects
# count degrees (hist) and close wedges on each row's card; every row's
# first launch of each is held against its plain version
LOCAL_KERNELS = WORLD_HELD + ("hist", "close_wedges")


def local_specs(api, sizes: dict) -> dict:
    """Path 3l's specs: path 3k's GNM, SBM and RHG, and a fleet of 4
    GNM(2^22, 2^26), 4 SBM(2^22, 16 blocks) and that RHG(2^20)."""
    sbm = dict(n=sizes["serve_n"], blocks=16, p_in=2.0 ** -15, p_out=2.0 ** -19)
    specs = {k: v for k, v in world_specs(api, sizes).items() if k in ("gnm", "sbm", "rhg")}
    specs["fleet"] = ([api.GNM(n=sizes["serve_n"], m=sizes["serve_m"], seed=40 + i)
                       for i in range(4)]
                      + [api.SBM(seed=50 + i, **sbm) for i in range(4)] + [specs["rhg"]])
    return specs


def edge_digest(e) -> tuple:
    """``(edges, digest)`` of an edge list, order-sensitive, computed on its
    device (:class:`Digests` of one PE)."""
    return Digests().split(e, [len(e)], 0).of(0)


def stream_chunks(chunks, mesh=None, per_pe=None, overlap: int = 0) -> list:
    """``(pe, edges, digest)`` of every chunk of a stream, in order (each
    chunk also added to the ``per_pe`` :class:`Digests` when given); on a
    mesh each chunk's buffer must lie on the device of the row that
    streams its PE (``runtime.stream_row``: with ``overlap``, the row of
    its segment, as the reference places it)."""
    from repro_torch.distrib.runtime import stream_row

    out = []
    for ch in chunks:
        if mesh is not None:
            want = mesh.devices[stream_row(LOCAL_P, mesh.size, ch.pe, overlap)]
            require(ch.buffer.device == want,
                    f"PE {ch.pe}'s chunk on {ch.buffer.device}, its row's device is {want}")
        d, e = Digests(), ch.edges()
        d.add(ch.pe, e)
        if per_pe is not None:
            per_pe.add(ch.pe, e)
        out.append((ch.pe, *d.of(ch.pe)))
    return out


def same_stats(a, b, what: str) -> None:
    """Two ``StatsReport`` objects equal field by field: the counts, every
    degree summary (histogram, moments, degree array) and the clustering
    report."""
    import numpy as np
    import torch
    for f in ("n", "P", "directed", "mode", "num_edges", "metrics"):
        require(getattr(a, f) == getattr(b, f), f"{what}: {f} {getattr(a, f)} != "
                f"{getattr(b, f)}")
    for side in ("degree", "in_degree"):
        x, y = getattr(a, side), getattr(b, side)
        require((x is None) == (y is None), f"{what}: {side} present on one side only")
        if x is None:
            continue
        require(torch.equal(x.log2_hist.cpu(), y.log2_hist.cpu()), f"{what}: {side} log2_hist")
        for f in ("deg_sum", "deg_sumsq", "deg_max", "num_isolated"):
            require(getattr(x, f) == getattr(y, f), f"{what}: {side} {f}")
        require((x.degrees is None) == (y.degrees is None)
                and (x.degrees is None or torch.equal(x.degrees.cpu(), y.degrees.cpu())),
                f"{what}: {side} degrees")
    require((a.clustering is None) == (b.clustering is None), f"{what}: clustering")
    if a.clustering is not None:
        for f in CLUSTER_FIELDS:
            require(np.array_equal(getattr(a.clustering, f), getattr(b.clustering, f)),
                    f"{what}: clustering {f}")


def local_collects(tag: str, mesh, one, sizes: dict, errs: Errors) -> dict:
    """``collect`` on ``mesh`` (gathered on its first device) against one
    device ``one``, P = 16, report field by field: GNP(2^22) exact, path
    3a's directed GNP(2^24) binned (in-degrees), SBM(2^24) and RHG(2^20)
    with clustering; every row's first ``hist`` and ``close_wedges``
    launch held against its plain version, each chunk counted on its row's
    card (``counted_collect``).  Then ``validate`` of the GNP and the SBM on
    both.  Walls and the gathering device's peak, beside one device's."""
    import torch
    from repro_torch import api

    D, P, first = mesh.size, LOCAL_P, mesh.devices[0]
    n_c, n_s, p_in, p_out = sizes["collect_n"], sizes["sbm_n"], *sizes["sbm_p"]
    clustering = ("degree", "clustering")
    cases = [("GNP exact", api.GNP(n=n_c, p=16 / n_c, seed=3), {}),
             ("directed GNP binned", api.GNP(n=sizes["stream_n"], p=16 / sizes["stream_n"],
                                             directed=True, seed=2), {"mode": "binned"}),
             ("SBM clustering", api.SBM(n=n_s, blocks=sizes["sbm_blocks"], p_in=p_in,
                                        p_out=p_out, seed=10), {"metrics": clustering}),
             ("RHG clustering", api.RHG(n=sizes["rhg_n"], avg_deg=16, gamma=2.8, seed=5),
              {"metrics": clustering, "batch": sizes["batch"]})]

    def sync():
        mesh.sync()
        torch.cuda.synchronize(one)

    def run(spec, m, dev, kw):
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        rep, launches, _ = counted_collect(spec, P, dev, mesh=m, **kw)
        sync()
        return rep, launches, time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) - base

    walls, peaks, lines = {}, {}, []
    for label, spec, kw in cases:
        wedges = "clustering" in kw.get("metrics", ())
        with held_kernels(errs, f"{tag} collect {label}", first_only=True,
                          kernels=stats_kernels(), per=lambda: CHUNK_ROW[0]) as held:
            got, hl, wall, peak = run(spec, mesh, first, kw)
        for k in ("hist",) + (("close_wedges",) if wedges else ()):
            require(held.seen.get(k) == D, f"{tag} collect {label}: {k} held on "
                    f"{held.seen.get(k)} of {D} rows")
        walls[f"collect {label}, {D} rows (first launches held, plain versions "
              f"{held.plain_s:.3f}s)"] = wall
        want = ONE_DEVICE_REPORTS.get(report_key(spec, P, kw))
        if want is None:
            want, hl1, walls[f"collect {label}, one device"], peak1 = run(spec, None, one, kw)
            ONE_DEVICE_REPORTS[report_key(spec, P, kw)] = want
        else:
            hl1, peak1 = "path 3d's", None
        same_stats(got, want, f"{tag} collect {label}")
        peaks[label] = (peak, peak1)
        lines.append(f"{label}: {got.num_edges} edges, {hl} / {hl1} hist launches")
    for label, spec, _ in cases[::2]:
        sync()
        t0 = time.perf_counter()
        got = api.validate(spec, P, mesh=mesh, device=first)
        sync()
        walls[f"validate {label.split()[0]}, {D} rows"] = time.perf_counter() - t0
        want = api.validate(spec, P, device=one)
        require(str(got) == str(want) and got.passed == want.passed,
                f"{tag}: validate {spec} on {D} rows != one device:\n{got}\n{want}")
        lines.append(f"validate {label.split()[0]} {'PASS' if got.passed else 'FAIL'} == one "
                     f"device's")
    print(f"  {tag} collects ({card_line()}), P = {P}, every report == one device's field by "
          f"field: " + "; ".join(lines) + "; " + ", ".join(
              f"{k} {v:.3f}s" for k, v in walls.items())
          + "; the gathering device's peak, rows / one device: " + ", ".join(
              f"{k} {a / 2 ** 30:.3f} / " + ("path 3d's report" if b is None else
                                              f"{b / 2 ** 30:.3f} GiB")
              for k, (a, b) in peaks.items()), flush=True)
    return {"walls": walls, "peaks": peaks}


def local_run(tag: str, mesh, one, specs: dict, sizes: dict, errs: Errors) -> dict:
    """Path 3l on ``mesh`` against the one device ``one``, P = 16:
    ``generate`` of GNM (each row's first ``chunk_sample`` and
    ``chunk_decode`` launch held), then timed in turns with the one
    device (walls, the gathering device's peak); the SBM stream with
    overlap 0 and 2 and the RHG stream (each row's first ``pair_edges``
    launch held) against the integer ``mesh=D`` stream on ``one``, chunk
    by chunk; the fleet with the last row dead at slab 1, every ticket
    against ``generate`` on ``one``."""
    import torch
    from repro_torch import api
    from repro_torch.serve import Service

    D, P, B = mesh.size, LOCAL_P, sizes["batch"]
    first = mesh.devices[0]
    walls, peaks = {}, {}

    def row_of():
        return torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream

    def sync():
        mesh.sync()
        torch.cuda.synchronize(one)

    def generate(m, dev):
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        e = api.generate(specs["gnm"], P, mesh=m, device=dev).edges
        sync()
        wall = time.perf_counter() - t0
        return edge_digest(e), wall, torch.cuda.max_memory_allocated(dev) - base

    with held_kernels(errs, f"{tag} GNM generate", first_only=True,
                      names=("chunk_sample", "chunk_decode"), per=row_of) as held:
        digest, wall, _ = generate(mesh, first)
    for k in ("chunk_sample", "chunk_decode"):
        require(held.seen.get(k) == D, f"{tag}: {k} held on {held.seen.get(k)} of {D} rows")
    walls[f"GNM generate, {D} rows, every row's first launches held (plain versions "
          f"{held.plain_s:.3f}s)"] = wall
    # in turns: one device, the rows, the rows, one device
    for i, (label, m, dev) in enumerate([("one device", None, one), (f"{D} rows", mesh, first),
                                         (f"{D} rows", mesh, first), ("one device", None, one)]):
        got, walls[f"GNM generate, {label} ({i + 1})"], peaks[f"{label} ({i + 1})"] = \
            generate(m, dev)
        require(got == digest, f"{tag}: GNM edges {got} on {label} != {digest}")
    m = digest[0]

    for overlap in (0, 2):
        sync()
        t0 = time.perf_counter()
        same = stream_chunks(api.iter_edge_chunks(specs["sbm"], P, mesh=D, device=one,
                                                  batch=B, overlap=overlap))
        sync()
        walls[f"SBM stream overlap {overlap}, one device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = stream_chunks(api.iter_edge_chunks(specs["sbm"], P, mesh=mesh, batch=B,
                                                 overlap=overlap), mesh, overlap=overlap)
        sync()
        walls[f"SBM stream overlap {overlap}, {D} rows"] = time.perf_counter() - t0
        require(got == same, f"{tag}: SBM stream (overlap {overlap}) != the mesh={D} stream")

    rhg = Digests()
    t0 = time.perf_counter()
    same = stream_chunks(api.iter_edge_chunks(specs["rhg"], P, mesh=D, device=one, batch=B),
                         per_pe=rhg)
    sync()
    walls["RHG stream, one device"] = time.perf_counter() - t0
    with held_kernels(errs, f"{tag} RHG stream", first_only=True, names=("pair_edges",),
                      per=row_of) as held:
        t0 = time.perf_counter()
        got = stream_chunks(api.iter_edge_chunks(specs["rhg"], P, mesh=mesh, batch=B), mesh)
        sync()
        walls[f"RHG stream, {D} rows (first launches held)"] = time.perf_counter() - t0
    require(held.seen.get("pair_edges") == D, f"{tag}: pair_edges held on "
            f"{held.seen.get('pair_edges')} of {D} rows")
    require(got == same, f"{tag}: RHG stream != the mesh={D} stream")
    rhg_counts = [rhg.of(pe)[0] for pe in range(P)]

    fleet = specs["fleet"]
    svc = Service(P, mesh=mesh, slab_batch=16, slab_bytes=sizes["serve_slab_bytes"])
    sync()
    t0 = time.perf_counter()
    tickets = [svc.submit(s) for s in fleet]
    svc.inject_fault([D - 1], at_slab=1)
    svc.drain()
    sync()
    walls[f"fleet, {D} rows, row {D - 1} dead at slab 1"] = time.perf_counter() - t0
    require(svc.scheduler.reissued > 0, f"{tag}: the fault reissued nothing")
    for t, spec in zip(tickets, fleet):
        e = t.result().edges
        require(e.device == first, f"{tag}: a ticket's edges on {e.device}, not {first}")
        if spec is specs["rhg"]:
            d = Digests().split(e, rhg_counts, 0)
            require(all(d.of(pe) == rhg.of(pe) for pe in range(P)),
                    f"{tag}: the fleet's RHG ticket != its stream")
        else:
            require(edge_digest(e) == edge_digest(api.generate(spec, P, device=one).edges),
                    f"{tag}: a fleet ticket of {spec} != generate")
    print(f"  {tag} ({card_line()}), P = {P}: GNM {m} edges, digest == one device's; "
          + ", ".join(f"{k} {v:.3f}s" for k, v in walls.items())
          + "; peak of the gathering device "
          + ", ".join(f"{k} {v / 2 ** 30:.3f} GiB" for k, v in peaks.items())
          + f"; fleet of {len(fleet)}: {svc.scheduler.slabs} slabs, {svc.scheduler.reissued} "
          f"slots reissued, every ticket == generate; SBM and RHG streams == the mesh={D} "
          f"stream chunk by chunk ({sum(rhg_counts)} RHG edges)", flush=True)
    return {"walls": walls, "peaks": peaks,
            "collects": local_collects(tag, mesh, one, sizes, errs)}


def phase_local(dev, sizes: dict) -> dict:
    """Phase 3l: one process over local devices (``--only local``): a
    ``LocalMesh`` of ``LOCAL_ROWS`` rows on this card, each on a stream of
    its own (:func:`local_run`), then, where the machine has two cards or
    more, ``mesh_for(16)``'s distinct cards.  Rows sharing one card check
    correctness, not scaling."""
    import torch
    from repro_torch import api
    from repro_torch.distrib import runtime
    from repro_torch.distrib.world import LocalMesh

    errs = Errors()
    specs = local_specs(api, sizes)
    runs = {"rows": local_run(f"{LOCAL_ROWS} rows on {dev}", LocalMesh([dev] * LOCAL_ROWS),
                              dev, specs, sizes, errs)}
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = runtime.mesh_for(LOCAL_P)
        runs["cards"] = local_run(f"mesh_for({LOCAL_P}) on {cards} cards", mesh, dev, specs,
                                  sizes, errs)
    else:
        print(f"  this machine has one card: mesh_for({LOCAL_P}) is one row on {dev}, the "
              f"one-device path; distinct cards were not run", flush=True)
    print(f"  {LOCAL_ROWS} rows on one card measure correctness, not scaling", flush=True)
    return {"errs": errs, "runs": runs}


def local_timing(dev, out: dict, errs: Errors) -> list:
    """Phase 4 of 3l: no kernel of its own; each row's first launches,
    held against their plain versions, join those kernels' errors."""
    for k in LOCAL_KERNELS:
        errs.max[k] = max(errs.max[k], out["errs"].max[k])
    return []


OFF_PATH = {"pair_mask": "euclid tile at its own contract's shape (the oracles' 128-row cell "
                         "blocks): the engine runs its tiles inside pair_edges, and rhg_pe, "
                         "the LM pipeline's graph, tests its segments with hyp_edges; its "
                         "launches are the contract check's (path 3g)"}


def kernel_lines(rows: list, errs: Errors, launches: dict) -> list:
    """The ``kernels`` line's entries; the bound is the larger of the
    byte time and the operation time.  ``ms`` is the mean of calls back to
    back, ``median_ms`` the median of calls timed one at a time; a row may
    end in a note on its shape."""
    lines = []
    for name, src, replaces, ms, median_ms, plain_ms, bytes_s, ops_s, lib_ms, *note in rows:
        note = note or ([OFF_PATH[name]] if name in OFF_PATH else [])
        lines.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                      "launches": launches[name], "max_abs_err": errs.max[name],
                      "ms": ms, "median_ms": median_ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_s, ops_s) * 1e3,
                      "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                      "library_ms": lib_ms, **({"note": note[0]} if note else {})})
    return lines


FULL = {"gnm_n": 1 << 24, "gnm_m": 1 << 28, "stream_n": 1 << 24, "collect_n": 1 << 22,
        "rgg_n": 1 << 22, "rhg_n": 1 << 20, "batch": 1 << 15,
        "rdg2_n": 1 << 20, "rdg3_n": 1 << 16, "brute2_n": 1 << 16, "brute3_n": 1 << 13,
        "rmat_log_n": 26, "rmat_m": 1 << 30, "ba_n": 1 << 25, "sbm_n": 1 << 24,
        "sbm_blocks": 16, "sbm_p": (2.0 ** -17, 2.0 ** -21),
        "serve_n": 1 << 22, "serve_m": 1 << 26, "serve_rhg_n": 1 << 20, "serve_rdg_n": 1 << 18,
        "serve_slab_bytes": 1 << 30,
        "lm_batch": 8, "lm_prompt": 256, "lm_steps": 64, "lm_check_steps": 16,
        "lm_profiled_steps": 16,
        "train_steps": 20, "train_ckpt_every": 12, "train_profiled_steps": 3,
        "train_overfit_steps": 30, "train_resume_steps": 3,
        "mesh_gen_n": 1 << 30, "mesh_gen_m": 1 << 34,
        "world_rdg_n": 1 << 16, "world_small_n": 1 << 14, "overlap_rdg_n": 1 << 18}
ER_KERNELS = ("chunk_sample", "chunk_decode", "hist")
GEOM_KERNELS = ("pair_edges", "cell_points", "hist")
RDG_KERNELS = ("triangulate", "circumspheres", "pair_edges", "cell_points")
FAMILY_KERNELS = ("chunk_rmat", "chunk_ba", "close_wedges", "hist", "chunk_sample",
                  "chunk_decode", "pair_edges")
STATS_KERNELS = ("hist", "chunk_sample", "chunk_decode", "pair_edges", "triangulate")
SERVE_KERNELS = ("hist", "chunk_sample", "chunk_decode", "chunk_ba", "chunk_rmat", "pair_edges",
                 "triangulate")
# rhg_pe tests adjacency with hyp_edges, gnm_undirected_pe samples and decodes
LM_KERNELS = ("hyp_edges", "chunk_sample", "chunk_decode")
# the training path's batches come from rhg_pe, whose adjacency is hyp_edges
TRAIN_KERNELS = ("hyp_edges",)
# the kernels the registry launches on the card (RDG's planning and the
# kernel cases among them)
# the generator cell runs PE 0's program of GNM(2^30, 2^34)
MESH_KERNELS = ("chunk_sample", "chunk_decode")
# a world's ranks sample, decode (GNM, SBM, the per-PE ER rows), test pairs
# (RHG, RDG), triangulate (RDG planning) and descend (rmat_pe)
WORLD_KERNELS = ("chunk_sample", "chunk_decode", "pair_edges", "triangulate", "chunk_rmat")
ANALYZE_KERNELS = ("chunk_sample", "chunk_decode", "chunk_ba", "chunk_rmat", "pair_edges",
                   "cell_points", "pair_mask", "triangulate", "circumspheres")


PATHS = {"er": ("3a Erdős–Rényi", phase_main, ER_KERNELS, phase_timing),
         "geom": ("3b geometric", phase_geom, GEOM_KERNELS, geom_timing),
         "rdg": ("3c Delaunay", phase_rdg, RDG_KERNELS, rdg_timing),
         "families": ("3d families", phase_families, FAMILY_KERNELS, families_timing),
         "stats": ("3e validation and overlap", phase_stats, STATS_KERNELS, stats_timing),
         "serve": ("3f serve", phase_serve, SERVE_KERNELS, serve_timing),
         "analyze": ("3g contract checking", phase_analyze, ANALYZE_KERNELS, analyze_timing),
         "lm": ("3h LM serving", phase_lm, LM_KERNELS, lm_timing),
         "train": ("3i training", phase_train, TRAIN_KERNELS, train_timing),
         "mesh": ("3j meshes and dry run", phase_mesh, MESH_KERNELS, mesh_timing),
         "world": ("3k generation across ranks", phase_world, WORLD_KERNELS, world_timing),
         "local": ("3l one process over local cards", phase_local, LOCAL_KERNELS,
                   local_timing)}


def main(argv=None) -> int:
    import argparse
    import torch

    ap = argparse.ArgumentParser(description="Card check of the PyTorch/CUDA port.")
    ap.add_argument("--only", choices=sorted(PATHS), action="append",
                    help="for comparing two checkouts on one card: build, run only this main "
                         "path (repeatable) and its phase 4 timing, and skip phases 1 and 2; "
                         "prints the kernels line, not the result line")
    ap.add_argument("--no-timing", action="store_true", help="with --only: skip phase 4")
    args = ap.parse_args(argv)
    if args.no_timing and not args.only:
        ap.error("--no-timing goes with --only")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card check needs one", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))       # the seeded inputs the CPU tests use too
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)      # the allocator, whose peak the paths reset, exists
    t0 = time.perf_counter()
    print(card_line())
    logs = build.build()
    for name, log in logs.items():
        print(f"  nvcc {name}:\n" + "\n".join("    " + ln for ln in log.strip().splitlines()
                                              if "Used" in ln or "entry" in ln))
    print(f"phase 0 build {time.perf_counter() - t0:.3f}s "
          f"({len(logs)} of {len(build.SOURCES)} libraries compiled)", flush=True)

    errs = Errors()
    if not args.only:
        t0 = time.perf_counter()
        phase_kernels(dev, errs)
        phase_libm(dev)
        phase_geom_kernels(dev, errs)
        phase_wide_rhg(dev, errs)
        phase_dt_kernels(dev, errs)
        phase_family_kernels(dev, errs)
        print(f"phase 1 kernels == plain {time.perf_counter() - t0:.3f}s", flush=True)

        t0 = time.perf_counter()
        phase_golden(dev)
        phase_golden_geom(dev)
        phase_golden_rdg(dev)
        phase_golden_families(dev)
        phase_golden_stats(dev)
        print(f"phase 2 golden parity {time.perf_counter() - t0:.3f}s", flush=True)

    # each main path runs with the counters at 0 and is read right after
    launches = dict.fromkeys(build.LAUNCHES, 0)
    paths = [PATHS[p] for p in PATHS if not args.only or p in args.only]
    outs = []
    for tag, phase, kernels, _ in paths:
        t0 = time.perf_counter()
        build.reset_launches()
        out = phase(dev, FULL)
        counts = dict(build.LAUNCHES)
        print(f"phase {tag} main path {time.perf_counter() - t0:.3f}s, launches {counts}",
              flush=True)
        for name in kernels:
            require(counts[name] > 0, f"kernel {name} was not launched on the {tag} path")
        for name, c in counts.items():
            launches[name] += c
        outs.append(out)

    if args.no_timing:
        print(card_line())
        return 0
    t0 = time.perf_counter()
    rows = [r for (*_, timing), out in zip(paths, outs) for r in timing(dev, out, errs)]
    kernels = kernel_lines(rows, errs, launches)
    print(f"phase 4 timing {time.perf_counter() - t0:.3f}s", flush=True)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    if args.only:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
