"""repro_torch.analyze: contract verification of the paper's
communication-free invariants (port of ``repro.analyze``).

Two cooperating passes behind one CLI (``python -m repro_torch.analyze``):

* **Pass 1** (:mod:`~repro_torch.analyze.opscan` +
  :mod:`~repro_torch.analyze.programs`): run every registered device
  program (8 families x plan kinds x ``run`` and ``stream_waves``, the
  serving slabs, the kernel entry points) on tiny specs under an aten op
  trace, and check the trace for collectives, host reads, draws from a
  ``torch.Generator``, float64 in pinned-float32 paths and
  data-dependent shapes, attaching the analytic bytes and operations of
  its kernel launches from :mod:`repro_torch.launch.cost`.  The
  runtime's ``check=True`` assertion runs the same scan
  (:func:`~repro_torch.analyze.opscan.assert_communication_free`).

* **Pass 2** (:mod:`~repro_torch.analyze.lint`): an AST linter over the
  tree encoding the source-level rules, with inline
  ``# repro: allow(<rule>)`` suppressions.

The import surface is layered as the reference's: :mod:`.opscan` and
:mod:`.lint` import neither the engine nor the API (so the kernels and
the runtime can import the scanner without a cycle);
:mod:`.programs`, which imports the full API, loads lazily via
``__getattr__``.
"""
from __future__ import annotations

from .lint import (  # noqa: F401
    LINT_RULES,
    LintFinding,
    lint_paths,
    lint_source,
)
from .opscan import (  # noqa: F401
    Contract,
    Finding,
    OP_RULES,
    ScanReport,
    assert_communication_free,
    collective_ops_in,
    scan_call,
    scan_census,
    trace,
)

__all__ = [
    "Contract", "Finding", "OP_RULES", "ScanReport",
    "assert_communication_free", "collective_ops_in", "scan_call", "scan_census",
    "trace", "LINT_RULES", "LintFinding", "lint_paths", "lint_source", "programs",
]


def __getattr__(name: str):
    if name == "programs":
        import importlib

        return importlib.import_module(".programs", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
