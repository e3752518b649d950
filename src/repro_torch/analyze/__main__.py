"""CLI gate: ``python -m repro_torch.analyze``.

    python -m repro_torch.analyze --all-programs --lint src/repro_torch chip_smoke.py \\
        --fail-on-violation

Pass 1 runs every registered program (all families x plan kinds x
run/wave, the serving slabs, the kernel entry points) under the op scan
on ``--device`` (CUDA unless ``cpu``); Pass 2 lints the given paths.
``--json`` writes the full machine-readable report; ``--fail-on-violation``
exits 1 if either pass found anything (``tests/test_torch_analyze.py``
plants violations to prove it fires).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="contract verifier for the communication-free invariants "
                    "(op-trace scan + AST lint)")
    ap.add_argument("--all-programs", action="store_true",
                    help="Pass 1 over every registered program "
                         "(families x plan kinds x run/wave + serve + kernels)")
    ap.add_argument("--families", default=None,
                    help="comma-separated family subset for Pass 1 "
                         "(e.g. gnm,rgg,kernels); implies Pass 1")
    ap.add_argument("--pes", type=int, default=4,
                    help="virtual PEs per plan (default 4)")
    ap.add_argument("--batch", type=int, default=4,
                    help="wave batch per mesh row (default 4)")
    ap.add_argument("--lint", nargs="*", default=None, metavar="PATH",
                    help="Pass 2 paths (files or directories)")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the analytic bytes/operations of the launches")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write the machine-readable report here")
    ap.add_argument("--fail-on-violation", action="store_true",
                    help="exit 1 if any pass reports a violation")
    ap.add_argument("--device", default=None,
                    help="where Pass 1 runs the programs (CUDA unless 'cpu')")
    return ap


def main(argv: List[str] = None) -> int:
    args = build_parser().parse_args(argv)
    run_programs = args.all_programs or args.families is not None
    run_lint = args.lint is not None
    if not run_programs and not run_lint:
        # bare invocation: the full gate over the default surfaces
        run_programs, run_lint = True, True
        args.lint = ["src/repro_torch", "chip_smoke.py"]

    report = {"programs": [], "lint": [], "summary": {}}
    violations = 0

    if run_programs:
        from ..distrib.runtime import resolve_device
        from . import programs as _programs

        dev = resolve_device(args.device)
        families = args.families.split(",") if args.families else None
        reports = _programs.scan_programs(
            families, P=args.pes, batch=args.batch,
            with_cost=not args.no_cost, device=dev)
        for r in reports:
            report["programs"].append(r.to_json())
            flag = "ok" if r.ok else "VIOLATION"
            cost = (f"  ops={r.flops:,.0f}  bytes={r.bytes:,.0f}"
                    if r.flops is not None else "")
            print(f"[pass1] {r.name:<32} {flag}{cost}")
            if r.error:
                print(f"        error: {r.error}")
                violations += 1
            for f in r.scan.findings:
                print(f"        {f.rule}: {f.detail}")
                violations += 1

    if run_lint:
        from .lint import lint_paths

        findings = lint_paths(args.lint)
        for f in findings:
            report["lint"].append(f.to_json())
            print(f"[pass2] {f.format()}")
        violations += len(findings)

    report["summary"] = {
        "programs_scanned": len(report["programs"]),
        "lint_findings": len(report["lint"]),
        "violations": violations,
        "ok": violations == 0,
    }
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"report written to {args.json}")

    if violations:
        print(f"{violations} contract violation(s) found")
        return 1 if args.fail_on_violation else 0
    print("all contracts verified: zero collectives, no host reads, "
          "no generator draws, static shapes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
