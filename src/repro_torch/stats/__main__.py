"""CLI smoke validation: ``python -m repro_torch.stats [--n N] [--pes P]
[--device cuda:I|cpu]``.

Validates one ER and one RHG instance against their closed-form laws on
the local cards (every card that divides P, as ``launch/generate.py``
does; ``--device`` names one device instead) and exits non-zero on any
failed gate: the guard that generation and measurement stay
statistically sound.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.stats",
                                 description=__doc__)
    ap.add_argument("--n", type=int, default=1 << 12, help="vertices per instance")
    ap.add_argument("--pes", type=int, default=4, help="virtual PEs")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu (the kernels' plain versions), or one card; by default "
                         "every local card that divides --pes (runtime.mesh_for)")
    args = ap.parse_args(argv)

    from repro_torch.api import GNP, RHG
    from repro_torch.stats import validate

    specs = [
        GNP(n=args.n, p=16.0 / args.n, seed=args.seed),
        RHG(n=args.n, avg_deg=8, gamma=2.7, seed=args.seed),
    ]
    ok = True
    for spec in specs:
        report = validate(spec, args.pes, device=args.device)
        print(report)
        ok &= report.passed
    print("all gates passed" if ok else "GATE FAILURE", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
