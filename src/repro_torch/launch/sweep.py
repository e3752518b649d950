"""Dry-run sweep (port of ``repro.launch.sweep``): every (arch x
shape x mesh) cell in its own subprocess (a fresh process group, bounded
memory), with a time limit a cell, results cached as JSON.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--jobs 4] [--outdir DIR]
    PYTHONPATH=src python -m repro_torch.launch.roofline --dir DIR

The cells are the reference's: the single-pod mesh for every shape, the
multi-pod mesh for ``train_4k`` of every architecture, and the generator
cell on both meshes.  A cell whose JSON exists is not run again.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..configs.base import ARCHS as _ARCHS

ARCHS = [
    "smollm_360m", "qwen3_0p6b", "mamba2_2p7b", "hubert_xlarge",
    "deepseek_v2_lite_16b", "granite_20b", "gemma3_27b",
    "mixtral_8x7b", "jamba_v0_1_52b", "qwen2_vl_72b",
]
assert sorted(ARCHS) == sorted(_ARCHS)
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "torch_dryrun")
CELL_TIMEOUT = 3600     # seconds a cell, the reference's


def _tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}.{shape}.{'mp' if multi_pod else 'sp'}"


def error_reason(stderr: str) -> str:
    """The exception line of a failed cell's output, cut to 80 characters
    (``|`` is a table's separator)."""
    lines = [ln.replace("[rank0]:", "").strip() for ln in stderr.splitlines()]
    lines = [ln for ln in lines if ln]
    last = next((ln for ln in reversed(lines) if "Error" in ln.split(":")[0]),
                lines[-1] if lines else "")
    return last.replace("|", "/")[:80]


def run_one(arch: str, shape: str, multi_pod: bool, outdir: str,
            timeout: float = CELL_TIMEOUT, device: str = "cuda") -> dict:
    """One cell's record: the cached JSON, or a fresh ``python -m
    repro_torch.launch.dryrun`` whose failure or time-out is recorded as
    ``status: error`` / ``timeout``.  ``device`` is the generator cell's."""
    out = os.path.join(outdir, _tag(arch, shape, multi_pod) + ".json")
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out, "--device", device]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    base = {"arch": arch, "shape": shape, "multi_pod": multi_pod}
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        res = dict(base, status="timeout", reason=f"no record within {timeout:.0f} s")
    else:
        if r.returncode == 0 and os.path.exists(out):
            with open(out) as f:
                res = json.load(f)
        else:
            res = dict(base, status="error", stderr=r.stderr[-2000:],
                       reason=error_reason(r.stderr))
    if res.get("status") in ("error", "timeout"):
        with open(out, "w") as f:
            json.dump(res, f)
    print(f"[{time.strftime('%H:%M:%S')}] {_tag(arch, shape, multi_pod)}: {res['status']} "
          f"({time.time() - t0:.0f}s)", flush=True)
    return res


def cells(archs, shapes) -> list:
    """Single pod: every shape (the full roofline table); multi-pod:
    ``train_4k`` of every architecture (the ``pod`` axis shards); then
    the generator cell on both meshes."""
    out = [(a, s, False) for a in archs for s in shapes]
    out += [(a, "train_4k", True) for a in archs]
    out += [("kagen_er_gnm", "gen", mp) for mp in (False, True)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep")
    ap.add_argument("--outdir", default=os.path.abspath(RESULTS))
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--jobs", type=int, default=1, help="cells run at once")
    ap.add_argument("--device", default="cuda",
                    help="the generator cells' device (cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    todo = cells(args.archs.split(","), args.shapes.split(","))
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        summary = list(pool.map(lambda c: run_one(*c, args.outdir, device=args.device), todo))
    ok = sum(1 for s in summary if s.get("status") == "ok")
    skip = sum(1 for s in summary if s.get("status") == "skipped")
    err = [f"{s['arch']}.{s['shape']}" for s in summary
           if s.get("status") not in ("ok", "skipped")]
    print(f"\nDONE: {ok} ok, {skip} skipped, errors: {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
