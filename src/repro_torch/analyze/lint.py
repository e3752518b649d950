"""Pass 2: the repo-specific AST linter (port of ``repro.analyze.lint``).

Pass 1 (:mod:`repro_torch.analyze.opscan`) proves the *executed*
programs honor the paper's contracts; this pass catches the violations
that no program shows: host-side plan emitters quietly reintroducing
``np.unique`` dedup, wall-clock seeding, draws from PyTorch's global or
seeded generators outside the hashed recursion-tree scheme, collectives
creeping into ``kernels/``, and deprecated shims or non-counter
pair-plan RNG in callers.  It is a plain ``ast`` walk (no imports of
the checked code), emits machine-readable findings, and honors an
inline suppression syntax::

    edges = np.unique(e, axis=0)  # repro: allow(no-numpy-unique) oracle dedup

The rule ids, the JSON fields and the suppression syntax are the
reference's; the rules that name a framework name PyTorch's spellings
(see ``src/repro_torch/analyze/README.md``).
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------------
# rule ids
# --------------------------------------------------------------------------

RULE_NP_UNIQUE = "no-numpy-unique"
RULE_PY_RANDOM = "no-python-random"
RULE_WALLCLOCK = "no-wallclock-state"
RULE_KERNEL_COLLECTIVE = "no-collectives-in-kernels"
RULE_RAW_PRNGKEY = "no-raw-prngkey"
RULE_DEPRECATED = "no-deprecated-shim"
RULE_NONCOUNTER_PAIR = "no-noncounter-pair-rng"
RULE_PER_CHUNK_LOOP = "no-per-chunk-host-loop"

LINT_RULES = (RULE_NP_UNIQUE, RULE_PY_RANDOM, RULE_WALLCLOCK,
              RULE_KERNEL_COLLECTIVE, RULE_RAW_PRNGKEY, RULE_DEPRECATED,
              RULE_NONCOUNTER_PAIR, RULE_PER_CHUNK_LOOP)

# counter-based key impls whose draws are pure in (key, slot); mirrors
# repro_torch.distrib.engine.COUNTER_RNGS without importing the engine
COUNTER_RNGS = frozenset({"threefry2x32"})

# geometric families whose edge phase runs on a PairPlan (recomputed
# cells => counter RNG only)
PAIR_PLAN_FAMILIES = frozenset({"RGG", "RHG", "RDG"})
PAIR_PLAN_EMITTERS = frozenset({
    "make_pair_plan", "rgg_pair_plan", "rhg_pair_plan", "rdg_pair_plan"})
SPEC_CONSUMERS = frozenset({
    "generate", "iter_edge_chunks", "iter_points", "collect", "validate",
    "plan", "point_plan"})

# the reference's legacy per-family union / sharded entry points
# (DeprecationWarning shims onto its api); code must call the front door
DEPRECATED_SHIMS = frozenset({
    "gnm_directed", "gnm_undirected", "gnp_undirected",
    "ba_union", "rmat_union", "sbm_union",
    "gnm_directed_sharded", "run_gnm_directed_sharded", "rgg_points_sharded",
})

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")

# per-chunk constructors: one Python call per chunk inside a loop means
# plan emission scales as interpreter time, not array time.  The
# vectorized level-synchronous emitters (chunk_plan_from_columns,
# hash_paths + PhiloxReplayer) replaced these loops; retained oracles
# suppress per line.  Replay loops drawing `binomial(rep.at(h), ...)`
# are intentionally NOT matched — they vectorize the hash, which is the
# per-chunk cost, and keep only the variate draw in Python.
# `Delaunay` (scipy Qhull) and `circumspheres` joined the set when the
# RDG emitter went level-synchronous: a per-chunk host triangulation or
# per-chunk certificate batch inside a loop is the retired pattern the
# batched device DT (repro_torch.kernels.delaunay.ops.batched_delaunay) replaced.
PER_CHUNK_CALLS = frozenset({
    "host_rng", "device_key", "ChunkSpec", "PairSpec",
    "_make_chunk", "_chunk_key", "Delaunay", "circumspheres"})

# PyTorch's draws from a process-global or seeded ``torch.Generator``:
# not a function of the hashed recursion-tree position
_TORCH_DRAWS = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm", "torch.normal",
    "torch.bernoulli", "torch.poisson", "torch.multinomial",
})
# in-place draws (tensor methods) and seeding calls, matched by name
_DRAW_METHODS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_", "manual_seed", "manual_seed_all",
})

_WALLCLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "numpy.random.seed", "numpy.random.default_rng",
    "os.urandom", "uuid.uuid4", "secrets.token_bytes",
})


# --------------------------------------------------------------------------
# path roles — which rules apply where
# --------------------------------------------------------------------------

def role_of(path: str) -> str:
    """Coarse role of a file: which rule scopes apply.

    ``emitter``  — plan emitters + device paths (core/, distrib/, api.py,
                   stats/): the communication-free generation machinery
    ``kernels``  — kernels/: the kernels and their plain versions, no
                   distrib
    ``obs``      — obs/: the host-side tracer/metrics layer.  Its *job*
                   is reading monotonic clocks, so the wall-clock rule
                   never applies there; everything it measures stays
                   outside the programs (Pass 1 still proves no host
                   read reaches a slot function)
    ``tests``    — tests are allowed to plant violations on purpose
    ``support``  — everything else (serve/, analyze/, launch/,
                   chip_smoke.py): only the portable rules
    """
    parts = os.path.normpath(path).replace("\\", "/").split("/")
    name = parts[-1]
    if "tests" in parts or name.startswith("test_") or name == "conftest.py":
        return "tests"
    if "kernels" in parts:
        return "kernels"
    if "obs" in parts:
        return "obs"
    if "core" in parts or "distrib" in parts or "stats" in parts \
            or name == "api.py":
        return "emitter"
    return "support"


# which roles each rule fires in (obs: every portable rule except the
# wall-clock one — monotonic timestamps are the tracer's purpose)
_RULE_ROLES: Dict[str, Set[str]] = {
    RULE_NP_UNIQUE: {"emitter", "kernels"},
    RULE_PY_RANDOM: {"emitter", "kernels", "obs", "support"},
    RULE_WALLCLOCK: {"emitter", "kernels"},
    RULE_KERNEL_COLLECTIVE: {"kernels"},
    RULE_RAW_PRNGKEY: {"emitter", "kernels"},
    RULE_DEPRECATED: {"emitter", "kernels", "obs", "support"},
    RULE_NONCOUNTER_PAIR: {"emitter", "kernels", "obs", "support"},
    RULE_PER_CHUNK_LOOP: {"emitter"},
}

# files exempt from specific rules (the rule's own implementation site)
_RULE_EXEMPT_FILES: Dict[str, Set[str]] = {
    RULE_RAW_PRNGKEY: {"prng.py"},
}


@dataclass(frozen=True)
class LintFinding:
    """One Pass-2 violation."""
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


# --------------------------------------------------------------------------
# name resolution
# --------------------------------------------------------------------------

class _Names:
    """Resolve local names to canonical dotted module paths.

    Tracks ``import numpy as np`` / ``import torch.distributed as dist``
    / ``from repro_torch.core.rgg import rgg_pair_plan`` so the rule
    tables can match on canonical names (``numpy.unique``,
    ``torch.distributed.all_reduce``) regardless of aliasing at the use
    site."""

    def __init__(self, tree: ast.AST):
        self.alias: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.alias[a.asname or a.name] = f"{node.module}.{a.name}"
        # canonical spellings for the usual suspects
        self.alias.setdefault("np", "numpy")
        self.alias.setdefault("dist", "torch.distributed")

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, or None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.alias.get(node.id, node.id)
        return ".".join([head] + list(reversed(parts)))


def _last_name(dotted: Optional[str]) -> Optional[str]:
    return dotted.rsplit(".", 1)[-1] if dotted else None


# --------------------------------------------------------------------------
# the linter
# --------------------------------------------------------------------------

def _spec_families(tree: ast.AST, names: _Names) -> Dict[str, str]:
    """``var -> family`` for simple ``spec = RGG(...)``-style assigns."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fam = _last_name(names.dotted(node.value.func))
            if fam in PAIR_PLAN_FAMILIES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = fam
    return out


def _allowed_rules(line_text: str) -> Set[str]:
    m = _ALLOW_RE.search(line_text)
    if not m:
        return set()
    return {tok.strip() for tok in m.group(1).split(",") if tok.strip()}


def lint_source(src: str, path: str, role: Optional[str] = None) -> List[LintFinding]:
    """Lint one module's source text; returns unsuppressed findings."""
    role = role if role is not None else role_of(path)
    if role == "tests":
        return []
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintFinding("syntax-error", path, e.lineno or 0, 0, str(e))]
    names = _Names(tree)
    lines = src.splitlines()
    fname = os.path.basename(path)
    spec_vars = _spec_families(tree, names)
    # names this module defines — a shim's defining module is not a use
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    raw: List[LintFinding] = []

    def hit(rule: str, node: ast.AST, message: str) -> None:
        if role not in _RULE_ROLES.get(rule, set()):
            return
        if fname in _RULE_EXEMPT_FILES.get(rule, set()):
            return
        raw.append(LintFinding(rule, path, getattr(node, "lineno", 0),
                               getattr(node, "col_offset", 0), message))

    for node in ast.walk(tree):
        # ---- imports -----------------------------------------------------
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random" or a.name.startswith("random."):
                    hit(RULE_PY_RANDOM, node,
                        "stdlib `random` is process-global mutable state; "
                        "use repro_torch.core.prng hashed streams")
                if a.name.startswith("repro_torch.distrib"):
                    hit(RULE_KERNEL_COLLECTIVE, node,
                        "kernels/ must stay below distrib/: import of "
                        f"`{a.name}` inverts the layering")
                if a.name.startswith("torch.distributed"):
                    hit(RULE_KERNEL_COLLECTIVE, node,
                        f"import of `{a.name}` inside kernels/: kernels "
                        f"must be communication-free")
        elif isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
            if mod == "random" or mod.startswith("random."):
                hit(RULE_PY_RANDOM, node,
                    "stdlib `random` is process-global mutable state; "
                    "use repro_torch.core.prng hashed streams")
            if mod.startswith("repro_torch.distrib") or (
                    role == "kernels" and "distrib" in mod.split(".")):
                hit(RULE_KERNEL_COLLECTIVE, node,
                    f"kernels/ must stay below distrib/: import of `{mod}` "
                    f"inverts the layering")
            if mod.startswith("torch.distributed") or (
                    mod == "torch" and any(a.name == "distributed" for a in node.names)):
                hit(RULE_KERNEL_COLLECTIVE, node,
                    f"import of `torch.distributed` inside kernels/: kernels "
                    f"must be communication-free")
            for a in node.names:
                if a.name in DEPRECATED_SHIMS and a.name not in defined \
                        and fname != "__init__.py":
                    hit(RULE_DEPRECATED, node,
                        f"`{a.name}` is a deprecated shim; call the "
                        f"repro_torch.api front door instead")

        # ---- calls -------------------------------------------------------
        elif isinstance(node, ast.Call):
            dn = names.dotted(node.func)
            last = _last_name(dn)

            if dn == "numpy.unique":
                hit(RULE_NP_UNIQUE, node,
                    "np.unique in an emitter/device path reintroduces the "
                    "O(m log m) sort/dedup that chunk ownership removed "
                    "(paper §4: the union of owned chunks is already exact)")

            if dn and (dn.startswith("random.") or dn == "random"):
                hit(RULE_PY_RANDOM, node,
                    "stdlib `random` draw: not a pure function of the "
                    "recursion-tree position")

            if dn in _WALLCLOCK_CALLS:
                if dn == "numpy.random.default_rng" and node.args:
                    pass  # seeded generator: deterministic
                else:
                    hit(RULE_WALLCLOCK, node,
                        f"`{dn}` is wall-clock / entropy-seeded state: two "
                        f"PEs recomputing the same chunk would disagree")

            if dn and dn.startswith("torch.distributed."):
                hit(RULE_KERNEL_COLLECTIVE, node,
                    f"`{dn}` inside kernels/: kernels must be "
                    f"communication-free (collectives live nowhere: the "
                    f"paper's invariant)")

            draw_method = isinstance(node.func, ast.Attribute) \
                and node.func.attr in _DRAW_METHODS
            if dn in _TORCH_DRAWS or draw_method:
                what = dn if dn in _TORCH_DRAWS else f".{node.func.attr}()"
                hit(RULE_RAW_PRNGKEY, node,
                    f"`{what}` draws from (or seeds) a torch.Generator outside "
                    f"core/prng.py: all draws must derive from the hashed "
                    f"recursion-tree keys (counter Threefry) so every PE "
                    f"recomputes identical streams")

            if last in DEPRECATED_SHIMS and last not in defined:
                hit(RULE_DEPRECATED, node,
                    f"`{last}` is a deprecated shim; call the repro_torch.api "
                    f"front door instead")

            # non-counter PRNG reaching a pair-plan path, statically
            for kw in node.keywords:
                if kw.arg != "rng_impl" or not isinstance(kw.value, ast.Constant):
                    continue
                impl = kw.value.value
                if not isinstance(impl, str) or impl in COUNTER_RNGS:
                    continue
                pairish = last in PAIR_PLAN_EMITTERS
                if not pairish and last in SPEC_CONSUMERS:
                    for arg in list(node.args) + [
                            k.value for k in node.keywords if k.arg != "rng_impl"]:
                        if isinstance(arg, ast.Call) and _last_name(
                                names.dotted(arg.func)) in PAIR_PLAN_FAMILIES:
                            pairish = True
                        elif isinstance(arg, ast.Name) and arg.id in spec_vars:
                            pairish = True
                    if isinstance(node.func, ast.Attribute) and isinstance(
                            node.func.value, ast.Name) \
                            and node.func.value.id in spec_vars:
                        pairish = True  # spec.plan(P, rng_impl=...)
                if pairish:
                    hit(RULE_NONCOUNTER_PAIR, node,
                        f"rng_impl={impl!r} on a pair-plan family: "
                        f"non-counter impls draw different values for the "
                        f"same key across rows, so recomputed cells "
                        f"disagree with themselves; use one of "
                        f"{sorted(COUNTER_RNGS)} (make_pair_plan raises the "
                        f"same error at plan time)")

        # ---- per-chunk host loops ---------------------------------------
        elif isinstance(node, (ast.For, ast.While, ast.ListComp,
                               ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            if isinstance(node, (ast.For, ast.While)):
                # calls in a For's `iter` run once, not per iteration
                body: List[ast.AST] = list(node.body) + list(node.orelse)
            else:
                body = [node]
            for sub in body:
                for inner in ast.walk(sub):
                    if not isinstance(inner, ast.Call):
                        continue
                    last_inner = _last_name(names.dotted(inner.func))
                    if last_inner in PER_CHUNK_CALLS:
                        # anchored to the Call so oracles suppress in place
                        hit(RULE_PER_CHUNK_LOOP, inner,
                            f"`{last_inner}` called once per chunk inside a "
                            f"host loop: plan emission pays interpreter time "
                            f"per chunk; emit level-synchronously "
                            f"(chunk_plan_from_columns / hash_paths) and "
                            f"keep loops for replayed variate draws only")

    out = []
    seen: Set[Tuple[str, int, int]] = set()
    for f in raw:
        key = (f.rule, f.line, f.col)
        if key in seen:  # nested loops re-visit the same call
            continue
        seen.add(key)
        line_text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        if f.rule in _allowed_rules(line_text):
            continue
        out.append(f)
    return out


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in {"__pycache__", ".git"}]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str]) -> List[LintFinding]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    findings: List[LintFinding] = []
    for path in iter_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            findings.append(LintFinding("io-error", path, 0, 0, str(e)))
            continue
        findings.extend(lint_source(src, path))
    return findings
