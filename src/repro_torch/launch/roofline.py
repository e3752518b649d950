"""Roofline model of the port's kernels on an H100 (port of the analytic
half of ``repro.launch.roofline``).

:class:`Peaks`, :func:`roofline_seconds` and :func:`achieved_fraction`
turn the analytic bytes and operations of :mod:`repro_torch.launch.cost`
into a time floor ``max(ops / peak ops, bytes / peak bandwidth)`` and
compare it with a measured time.  :func:`program_summary` does this for
one program's cost; :func:`trace_summary` joins a captured
:class:`repro_torch.obs.Tracer` with ``{span name: cost}``.

The reference's peaks are per-backend calibration knobs; the port's are
the H100 SXM's published rates (:data:`H100`), the ones ``chip_smoke.py``
states its bounds against.  The kernels' operations are integer
(Threefry), float32 (the pairmask tile) or float64 (the Delaunay
predicates), each against its own peak; the LM's matmuls are bfloat16,
against the tensor cores' dense rate.

The dry-run table CLI (:func:`make_table`, ``python -m
repro_torch.launch.roofline --dir DIR``) renders the records of
:mod:`repro_torch.launch.sweep` as the reference's does, against the
H100's 80 GB.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

#: integer operations of one Threefry-2x32 block: 20 rounds of (add,
#: rotate, xor) plus 6 key injections of two adds
THREEFRY_OPS = 20 * 3 + 6 * 2


@dataclass(frozen=True)
class Peaks:
    """Peak rates of the executing device: ``flops_per_s`` (float32, the
    reference's one compute rate) and ``bytes_per_s`` (memory), plus the
    int32 issue rate and the float64 rate where they differ."""
    flops_per_s: float
    bytes_per_s: float
    int32_ops_per_s: Optional[float] = None
    fp64_flops_per_s: Optional[float] = None
    bf16_flops_per_s: Optional[float] = None

    def ops_per_s(self, kind: str = "fp32") -> float:
        """The peak rate of operations of ``kind``: ``"int32"``, ``"fp32"``,
        ``"fp64"`` or ``"bf16"`` (dense tensor-core matmuls)."""
        rate = {"fp32": self.flops_per_s, "int32": self.int32_ops_per_s,
                "fp64": self.fp64_flops_per_s, "bf16": self.bf16_flops_per_s}[kind]
        return self.flops_per_s if rate is None else rate


# H100 SXM (NVIDIA data sheet / Hopper white paper), at its 700 W limit:
# HBM3 bandwidth; int32 issue = 132 SMs x 128 lanes x 1.98 GHz boost
# clock (the 64 INT32 lanes and the 64 FMA lanes, where the compiler
# issues integer adds and multiply-adds as IMAD: chunk_rmat ran its
# Threefry blocks at 1.2x the 64-lane rate on the card); float32 outside
# the tensor cores; float64 = 132 SMs x 64 FP64 lanes x 2 (an FMA) x
# 1.98 GHz (the Delaunay predicates are scalar float64 FMA chains whose
# rounding the tensor cores do not reproduce); bfloat16 = the dense
# (no sparsity) tensor-core rate, the LM's matmuls
H100 = Peaks(flops_per_s=67e12, bytes_per_s=3.35e12,
             int32_ops_per_s=132 * 128 * 1.98e9,
             fp64_flops_per_s=132 * 64 * 2 * 1.98e9,
             bf16_flops_per_s=989e12)


def default_peaks() -> Peaks:
    """:data:`H100`, the one card the port targets (the reference's
    ``REPRO_PEAK_*`` variables calibrate its backends and are not read)."""
    return H100


def roofline_seconds(flops: float, nbytes: float,
                     peaks: Optional[Peaks] = None) -> float:
    """The roofline time floor: max of compute and memory terms."""
    peaks = peaks if peaks is not None else default_peaks()
    return max(flops / peaks.flops_per_s, nbytes / peaks.bytes_per_s)


def achieved_fraction(flops: float, nbytes: float, measured_s: float,
                      peaks: Optional[Peaks] = None) -> Optional[float]:
    """roofline_floor / measured: 1.0 means running at the roofline;
    None when the measurement is missing or degenerate."""
    if not measured_s or measured_s <= 0:
        return None
    return roofline_seconds(flops, nbytes, peaks) / measured_s


def program_summary(cost, measured_s: Optional[float] = None,
                    peaks: Optional[Peaks] = None) -> dict:
    """Bytes, operations and the roofline verdict of one program's
    :class:`~repro_torch.launch.cost.Cost` (the reference takes a
    lowering; the port's cost is analytic).  ``measured_s`` is the
    measured execution time to compare against the floor."""
    peaks = peaks if peaks is not None else default_peaks()
    memory_s, compute_s = cost.seconds(peaks)
    floor = max(memory_s, compute_s)
    return {
        "ops": cost.ops,
        "op_kind": cost.op_kind,
        "bytes": cost.bytes,
        "roofline_s": floor,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "measured_s": measured_s,
        "achieved_fraction": floor / measured_s if measured_s and measured_s > 0 else None,
    }


def trace_summary(tr, programs: Optional[Dict[str, object]] = None,
                  peaks: Optional[Peaks] = None) -> dict:
    """Join a captured :class:`repro_torch.obs.Tracer` with program costs.

    ``programs`` maps a span-name prefix (``"run"``, ``"wave"``,
    ``"slab"``) to the cost of the program those spans timed; each entry
    gets a :func:`program_summary` with ``measured_s`` summed from the
    matching exec-phase spans (falling back to the trace's total exec
    time when no span matches)."""
    totals = tr.phase_totals()
    out = {"phases": totals, "programs": {}}
    spans = [s for s in tr.spans() if not s.instant and s.phase == "exec"]
    for name, cost in (programs or {}).items():
        measured = sum(s.seconds for s in spans
                       if s.name == name or s.name.startswith(name + "/"))
        if not measured:
            measured = totals.get("exec_s", 0.0)
        out["programs"][name] = program_summary(cost, measured, peaks)
    return out


# --------------------------------------------------------------------------
# the dry-run table CLI
# --------------------------------------------------------------------------

ARCH_ORDER = [
    "deepseek_v2_lite_16b", "mixtral_8x7b", "qwen2_vl_72b", "smollm_360m",
    "granite_20b", "gemma3_27b", "qwen3_0p6b", "jamba_v0_1_52b",
    "hubert_xlarge", "mamba2_2p7b", "kagen_er_gnm",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k", "gen"]

HBM_PER_CHIP = 80 * 10**9  # H100 SXM: 80 GB of HBM3 (data sheet)


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}"
    if x >= 1e-3:
        return f"{x*1e3:.1f}m"
    return f"{x*1e6:.0f}u"


def load(dirname):
    rows = {}
    for f in glob.glob(os.path.join(dirname, "*.json")):
        with open(f) as fh:
            d = json.load(fh)
        key = (d.get("arch"), d.get("shape"), bool(d.get("multi_pod")))
        rows[key] = d
    return rows


def _gen_row(rows, multi_pod):
    return next((d for (a, _, mp), d in sorted(rows.items(), key=str)
                 if a == "kagen_er_gnm" and mp == multi_pod), None)


def make_table(rows, multi_pod=False):
    out = []
    hdr = ("| arch | shape | compute_s | memory_s | collective_s | dominant | "
           "peak GB/chip | fits | useful-flops ratio | bottleneck note |")
    sep = "|" + "---|" * 10
    out.append(hdr)
    out.append(sep)
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            d = rows.get((arch, shape, multi_pod))
            if d is None and shape == "gen" and arch == "kagen_er_gnm":
                d = _gen_row(rows, multi_pod)
            if d is None:
                continue
            if d["status"] == "skipped":
                out.append(f"| {arch} | {shape} | - | - | - | skipped | - | - | - | {d['reason']} |")
                continue
            if d["status"] != "ok":
                note = d.get("reason") or d.get("stderr", "")[:40]
                out.append(f"| {arch} | {shape} | - | - | - | ERROR | - | - | - | {note} |")
                continue
            r = d["roofline"]
            peak = d.get("memory", {}).get("peak_per_device")
            peak_gb = f"{peak/10**9:.1f}" if peak else "-"
            fits = "yes" if (peak or 0) <= HBM_PER_CHIP else "NO"
            ratio = d.get("useful_flops_ratio")
            ratio_s = f"{ratio:.2f}" if ratio else "-"
            note = _note(d)
            out.append(
                f"| {arch} | {shape} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
                f"| {fmt_s(r['collective_s'])} | {d['dominant'].replace('_s','')} "
                f"| {peak_gb} | {fits} | {ratio_s} | {note} |"
            )
    return "\n".join(out)


def _note(d):
    dom = d["dominant"]
    colls = d.get("collectives", {})
    if d.get("zero_collectives"):
        return "communication-free by construction (asserted)"
    if dom == "collective_s":
        big = max(colls.items(), key=lambda kv: kv[1]["bytes"])[0] if colls else "?"
        return f"dominated by {big}; cut via RS/AG + bf16 gathers"
    if dom == "memory_s":
        return "bytes-proxy bound; fuse/avoid materialized intermediates"
    return "compute-bound: near roofline if overlap hides comm"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default=os.path.join("results", "torch_dryrun"))
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(make_table(rows, args.multi_pod))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
