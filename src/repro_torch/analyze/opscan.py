"""Pass 1: the op-trace contract scanner (the port's counterpart of
``repro.analyze.hloscan``).

The paper's central claim is that generation is *communication-free and
pseudorandomly recomputable* (Funke et al., 2017, §2): every PE derives
its share of the graph from hashed recursion-tree seeds alone, so a
device program must contain **no collective ops, no host reads, no
nondeterministic RNG and no dynamic shapes**.  The reference checks
that by walking the lowered module's text.  The port lowers no IR: a
slot function is eager PyTorch, a sequence of aten ops and kernel
launches.  So this module scans the **aten op trace of one execution**
of the program, recorded by a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that counts
every op (the *census*), and on the card under
``torch.cuda.set_sync_debug_mode("error")``, which turns any
synchronising CUDA call into an error the scan records.  It is the one
implementation behind both

* the runtime's once-per-entry ``check=True`` assertion
  (:func:`assert_communication_free` and :func:`assert_contract`,
  called from :mod:`repro_torch.distrib.runtime`), and
* the gate (``python -m repro_torch.analyze --all-programs``, via
  :mod:`repro_torch.analyze.programs`).

**Kernel entry points are opaque.**  Every ``kernels/*/ops.py`` entry
point that dispatches to a CUDA kernel or to its plain version is
wrapped in :func:`opaque`: inside it the census records one launch
(``kernel::<name>``) and none of the plain version's ops, so the CPU
sees the census the card sees, where the kernel is a ``ctypes`` call
that dispatch never sees.  A kernel's own contract is checked by its
own program case, which traces with ``opaque=False``.

Rules (ids are the reference's, shared with the JSON report and the
runtime error path):

==========================  ================================================
``collective-op``           any ``c10d::*``, ``_c10d_functional::*`` op
``host-callback``           a host read inside the program:
                            ``aten::_local_scalar_dense`` (``.item()``,
                            ``int(t)``, ``bool(t)``), ``aten::equal``,
                            ``aten::is_nonzero``, a device-to-host
                            ``copy_``/``_to_copy``, and on the card any
                            op that the sync-debug mode refuses
``nondeterministic-rng``    an op that draws from a ``torch.Generator``
                            (``uniform_``, ``normal_``, ``bernoulli``,
                            ``random_``, ``randint``, ``randperm``,
                            ``multinomial``, ``exponential_``, ...).
                            Forbidden in **every** program: unlike the
                            reference's ``rbg``, torch's generator is
                            not keyed by the plan, so a draw from it is
                            never a function of (key, slot), chunk
                            programs included
``f64-op``                  an op producing float64 values (not a view,
                            nor a move of a float64 input); a violation
                            only where the contract pins a float32 path
                            (the pairmask kernel); always counted
``dynamic-shape``           an op whose output shape depends on the
                            data: ``aten::nonzero``, ``masked_select``,
                            ``unique*``, a boolean-mask ``index`` or
                            ``index_put_``, ``repeat_interleave``
                            without ``output_size``
==========================  ================================================

What the trace cannot see: a ``.tolist()`` or ``.numpy()`` of a CPU
tensor dispatches no op, so on the CPU such a read shows only in the
card's run, as a device-to-host copy and a sync-debug error.  A blocking
host-to-device upload, which the sync-debug mode also refuses, waits for
the card but reads nothing back, and is not a finding.
"""
from __future__ import annotations

import functools
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# --------------------------------------------------------------------------
# rule ids
# --------------------------------------------------------------------------

RULE_COLLECTIVE = "collective-op"
RULE_HOST_CALLBACK = "host-callback"
RULE_NONDET_RNG = "nondeterministic-rng"
RULE_F64 = "f64-op"
RULE_DYNAMIC_SHAPE = "dynamic-shape"

OP_RULES = (RULE_COLLECTIVE, RULE_HOST_CALLBACK, RULE_NONDET_RNG,
            RULE_F64, RULE_DYNAMIC_SHAPE)

# --------------------------------------------------------------------------
# op classes, by aten name (overload stripped) or by the trace's tags
# --------------------------------------------------------------------------

_COLLECTIVE_NAMESPACES = ("c10d::", "_c10d_functional::", "c10d_functional::")
_HOST_READS = frozenset({"aten::_local_scalar_dense", "aten::equal", "aten::is_nonzero"})
_RNG_OPS = frozenset({
    "aten::uniform", "aten::uniform_", "aten::normal", "aten::normal_",
    "aten::bernoulli", "aten::bernoulli_", "aten::random", "aten::random_",
    "aten::randint", "aten::randint_like", "aten::randperm", "aten::multinomial",
    "aten::exponential", "aten::exponential_", "aten::geometric", "aten::geometric_",
    "aten::cauchy", "aten::cauchy_", "aten::log_normal", "aten::log_normal_",
    "aten::rand", "aten::rand_like", "aten::randn", "aten::randn_like",
    "aten::poisson", "aten::binomial", "aten::_standard_gamma", "aten::native_dropout",
})
_DYNAMIC_OPS = frozenset({
    "aten::nonzero", "aten::masked_select", "aten::unique", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::unique_dim_consecutive", "aten::argwhere",
})
_BOOL_INDEXED = frozenset({"aten::index", "aten::index_put", "aten::index_put_",
                           "aten::_index_put_impl", "aten::_index_put_impl_"})
_SIZED_BY_DATA = frozenset({"aten::repeat_interleave"})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_", "aten::_copy_from"})

# census tags: an op key is ``name`` or ``name[tag]``
TAG_F64 = "f64"
TAG_D2H = "d2h"
TAG_SYNC = "sync"
TAG_BOOL_INDEX = "bool-index"
TAG_NO_SIZE = "no-output-size"
#: census key prefix of an opaque kernel entry point's launch
KERNEL_PREFIX = "kernel::"


def _split(key: str) -> Tuple[str, frozenset]:
    """``(aten name without overload, tags)`` of a census key."""
    name, _, tags = key.partition("[")
    tags = frozenset(t for t in tags.rstrip("]").split(",") if t)
    base = name.split(".", 1)[0] if "::" in name else name
    return base, tags


# --------------------------------------------------------------------------
# contracts & reports
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Contract:
    """Which Pass-1 rules are *violations* for a given program.

    Collectives, host reads, dynamic shapes and draws from a
    ``torch.Generator`` are forbidden for every generator program: they
    are the paper's invariant itself.  ``forbid_f64`` pins
    declared-float32 paths (the pairmask kernel) against float64."""
    forbid_collectives: bool = True
    forbid_host_callbacks: bool = True
    forbid_dynamic_shapes: bool = True
    forbid_nondeterministic_rng: bool = True
    forbid_f64: bool = False


# every generator program's contract
GENERATOR_CONTRACT = Contract()
# pair/point programs: the same in the port (the reference adds its rbg
# rule here; the port forbids generator draws everywhere)
RECOMPUTE_CONTRACT = Contract()
# declared-float32 kernel paths additionally pin no float64
FLOAT32_KERNEL_CONTRACT = Contract(forbid_f64=True)


@dataclass(frozen=True)
class Finding:
    """One contract violation found in a program's op trace."""
    rule: str
    detail: str
    count: int = 1

    def to_json(self) -> dict:
        return {"rule": self.rule, "detail": self.detail, "count": self.count}


@dataclass
class ScanReport:
    """Op census of one program's execution + the contract verdict."""
    counts: Dict[str, int] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    collectives: List[str] = field(default_factory=list)
    host_callbacks: List[str] = field(default_factory=list)
    rng_ops: List[str] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "counts": dict(self.counts),
            "ops": dict(sorted(self.ops.items())),
            "launches": dict(sorted(self.launches.items())),
            "collectives": sorted(set(self.collectives)),
            "host_callbacks": sorted(set(self.host_callbacks)),
            "rng_ops": sorted(set(self.rng_ops)),
            "violations": [f.to_json() for f in self.findings],
            "ok": self.ok,
        }


def classify(key: str) -> List[str]:
    """The rules a census key falls under (an opaque launch: none)."""
    if key.startswith(KERNEL_PREFIX):
        return []
    base, tags = _split(key)
    rules = []
    if base.startswith(_COLLECTIVE_NAMESPACES):
        rules.append(RULE_COLLECTIVE)
    dynamic = base in _DYNAMIC_OPS or TAG_BOOL_INDEX in tags or TAG_NO_SIZE in tags
    # a dynamic-shape op's sync is its shape read: one finding, not two
    if base in _HOST_READS or TAG_D2H in tags or (TAG_SYNC in tags and not dynamic):
        rules.append(RULE_HOST_CALLBACK)
    if base in _RNG_OPS:
        rules.append(RULE_NONDET_RNG)
    if TAG_F64 in tags:
        rules.append(RULE_F64)
    if dynamic:
        rules.append(RULE_DYNAMIC_SHAPE)
    return rules


def scan_census(census: Mapping[str, int], contract: Contract = GENERATOR_CONTRACT
                ) -> ScanReport:
    """Classify an op census (``{op key: count}``, as :func:`trace`
    records it or written by hand) and report the contract's violations."""
    rep = ScanReport(ops=dict(census))
    by_rule: Dict[str, List[Tuple[str, int]]] = {r: [] for r in OP_RULES}
    for key, n in census.items():
        if key.startswith(KERNEL_PREFIX):
            rep.launches[key[len(KERNEL_PREFIX):]] = int(n)
        for rule in classify(key):
            by_rule[rule].append((key, int(n)))
    rep.collectives = [k for k, _ in by_rule[RULE_COLLECTIVE]]
    rep.host_callbacks = [k for k, _ in by_rule[RULE_HOST_CALLBACK]]
    rep.rng_ops = [k for k, _ in by_rule[RULE_NONDET_RNG]]
    forbid = {RULE_COLLECTIVE: contract.forbid_collectives,
              RULE_HOST_CALLBACK: contract.forbid_host_callbacks,
              RULE_NONDET_RNG: contract.forbid_nondeterministic_rng,
              RULE_F64: contract.forbid_f64,
              RULE_DYNAMIC_SHAPE: contract.forbid_dynamic_shapes}
    what = {RULE_COLLECTIVE: "collective ops in the program",
            RULE_HOST_CALLBACK: "host reads in the program",
            RULE_NONDET_RNG: "draws from a torch.Generator: not a pure function of "
                             "(key, slot), so recomputed cells disagree",
            RULE_F64: "float64 values in a declared-float32 path",
            RULE_DYNAMIC_SHAPE: "data-dependent shapes in the program"}
    for rule in OP_RULES:
        hits = by_rule[rule]
        total = sum(n for _, n in hits)
        rep.counts[rule] = total
        if hits and forbid[rule]:
            rep.findings.append(Finding(rule, f"{what[rule]}: {sorted(k for k, _ in hits)[:4]}",
                                        total))
    return rep


def collective_ops_in(census: Mapping[str, int]) -> List[str]:
    """The collective ops of a census; empty means communication-free."""
    return [k for k in census if RULE_COLLECTIVE in classify(k)]


def assert_communication_free(census: Mapping[str, int]) -> None:
    """Raise if a program's census holds any collective op (the
    reference's error text)."""
    ops = collective_ops_in(census)
    if ops:
        raise AssertionError(
            f"generator lowering contains collectives: {sorted(set(ops))}")


def assert_contract(census: Mapping[str, int], contract: Contract = GENERATOR_CONTRACT,
                    name: str = "program") -> ScanReport:
    """The runtime's check: :func:`assert_communication_free`'s error on
    a collective, else an ``AssertionError`` naming the first violated
    rule.  Returns the report of a clean program."""
    assert_communication_free(census)
    rep = scan_census(census, contract)
    if rep.findings:
        f = rep.findings[0]
        raise AssertionError(f"{name} violates {f.rule}: {f.detail}")
    return rep


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

# .stack: the active traces' (census, calls), .depth: opaque nesting
_STATE = threading.local()
# traces active on any thread: while 0, an opaque entry point reads
# nothing else
_ACTIVE = 0
_ACTIVE_LOCK = threading.Lock()


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _copy_between(base: str, args, out, src: str, dst: str) -> bool:
    """Whether a copy op moved a tensor from device type ``src`` to ``dst``."""
    if base not in _COPIES:
        return False
    srcs = list(_tensors(args[1] if base == "aten::copy_" else args[:1]))
    dsts = list(_tensors(out))
    return bool(srcs and dsts) and all(t.device.type == src for t in srcs) \
        and all(t.device.type == dst for t in dsts)


def _device_to_host(base: str, args, kwargs, out) -> bool:
    return _copy_between(base, args, out, "cuda", "cpu")


_LIFTS = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy", "aten::lift"})


def _makes_f64(func, base: str, args, out) -> bool:
    """Whether an op produces float64 values: not a view, a constant made
    from host data, or a copy of a float64 tensor (a plan's float64 table
    moved or reshaped is an input, not a promotion)."""
    if func.is_view or base in _LIFTS:
        return False
    if not any(t.dtype == torch.float64 for t in _tensors(out)):
        return False
    if base in _COPIES:
        src = list(_tensors(args[1] if base == "aten::copy_" else args[:1]))
        return not src or any(t.dtype != torch.float64 for t in src)
    return True


def _key(func, args, kwargs, out, synced: bool) -> str:
    name = func.name()
    base = name.split(".", 1)[0]
    tags = [TAG_SYNC] if synced else []
    if _makes_f64(func, base, args, out):
        tags.append(TAG_F64)
    if _device_to_host(base, args, kwargs, out):
        tags.append(TAG_D2H)
    if base in _BOOL_INDEXED and len(args) > 1 and isinstance(args[1], (list, tuple)) and any(
            isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
            for t in args[1]):
        tags.append(TAG_BOOL_INDEX)
    if base in _SIZED_BY_DATA and kwargs.get("output_size") is None:
        tags.append(TAG_NO_SIZE)
    return f"{name}[{','.join(tags)}]" if tags else name


def _sync_refused(e: RuntimeError) -> bool:
    return "synchroniz" in str(e)


class _CensusMode(TorchDispatchMode):
    """Counts every aten op into ``census`` (outside opaque kernel entry
    points, unless ``opaque`` is off); with ``sync_debug``, an op the
    card's sync-debug mode refuses is recorded and run again without it."""

    def __init__(self, census: Counter, opaque: bool, sync_debug: bool):
        super().__init__()
        self.census, self.opaque, self.sync_debug = census, opaque, sync_debug

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        hidden = self.opaque and getattr(_STATE, "depth", 0) > 0
        synced = False
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if not (self.sync_debug and _sync_refused(e)):
                raise
            synced = True
            torch.cuda.set_sync_debug_mode(0)
            try:
                out = func(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("error")
            # a blocking upload waits for the card but reads nothing back
            synced = not _copy_between(func.name().split(".", 1)[0], args, out,
                                       "cpu", "cuda")
        # a host read inside an opaque entry point is the program's too
        if not hidden or synced:
            self.census[_key(func, args, kwargs, out, synced)] += 1
        return out


@contextmanager
def trace(*, opaque: bool = True, sync_debug: bool = False,
          calls: Optional[list] = None) -> Iterator[Counter]:
    """Record the census of everything run on this thread inside the
    block.  ``opaque``: kernel entry points count as one launch each and
    hide their ops.  ``sync_debug`` (a card): run under
    ``set_sync_debug_mode("error")``, recording every refused op (the
    mode is the process's, so no other thread should touch the card).
    ``calls``, a list, receives ``(kernel, args, kwargs)`` of every
    kernel entry point called (what :func:`repro_torch.launch.cost.
    launch_cost` prices)."""
    census: Counter = Counter()
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
        _STATE.depth = 0
    stack.append((census, calls))
    _count_active(1)
    debug = sync_debug and torch.cuda.is_available()
    before = torch.cuda.get_sync_debug_mode() if debug else 0
    try:
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        with _CensusMode(census, opaque, debug):
            yield census
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode(before)
        stack.pop()
        _count_active(-1)


def _count_active(delta: int) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE += delta


def scan_call(fn, *args, contract: Contract = GENERATOR_CONTRACT, opaque: bool = True,
              sync_debug: bool = False, **kwargs):
    """``(fn(*args, **kwargs), ScanReport)``: one traced execution."""
    with trace(opaque=opaque, sync_debug=sync_debug) as census:
        out = fn(*args, **kwargs)
    return out, scan_census(census, contract)


def opaque(name: str):
    """Decorate a kernel entry point: inside a :func:`trace` on this
    thread, a call counts as one ``kernel::<name>`` launch and hides its
    ops (an entry point called by another counts nothing).  While no
    trace is active it costs one read of a module counter."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            stack = getattr(_STATE, "stack", None)
            if not stack:
                return fn(*args, **kwargs)
            if _STATE.depth == 0:
                census, calls = stack[-1]
                census[KERNEL_PREFIX + name] += 1
                if calls is not None:
                    calls.append((name, args, kwargs))
            _STATE.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                _STATE.depth -= 1
        return call
    return wrap
