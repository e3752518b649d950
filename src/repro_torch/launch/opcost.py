"""Per-device cost of one execution (the port's counterpart of
``repro.launch.hlocost.HloCost``).

The reference parses the optimized HLO of a compiled step; the port has
no HLO, so :class:`OpCost` counts one execution instead, op by op, on the
ops each device runs.  Under DTensor an op on DTensors is first seen
whole; the mode lets DTensor run it (it returns ``NotImplemented``, as
``CommDebugMode`` does) and counts the local ops DTensor issues on its
shards and the collectives it issues to redistribute them.  An op on
fake tensors (DTensor's sharding propagation runs one on global shapes to
learn an output's metadata) is not the device's work and is not counted.

Counts, each mirroring ``hlocost.py``'s (its module docstring):

* ``flops``: a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, attention) by ``torch.utils.flop_counter``'s formulas,
  ``2 * M * N * K`` for a product, which is ``hlocost``'s ``dot``
  (``2 * numel(result) * prod(contracted dims)``); an elementwise op the
  numel of its result; a reduction the numel of its input.  The three
  are kept apart (``flops_by``): the matmul flops equal what
  ``FlopCounterMode`` counts on the same ops.
* ``bytes``: the result plus operand bytes of each op that materialises
  a result (views, aliases and metadata are free), the same first-order
  HBM-traffic proxy as ``hlocost``'s, with no reuse between ops.
* ``collectives``: by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``), a count and the bytes of each
  result (``dryrun.collective_stats``' result-shape proxy).
* ``peak_bytes``: the largest sum of the live storages during the
  execution, each rounded up to the CUDA caching allocator's 512 bytes,
  the tensors alive at the start included (:meth:`OpCost.hold`).
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_ALLOC_ROUND = 512       # the CUDA caching allocator's smallest block

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast_": "broadcast",
}
_FREE = {"detach", "alias", "empty", "empty_strided", "empty_like", "lift_fresh"}


def _dtensor_types():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # a build without torch.distributed
        return ()
    return (DTensor,)


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts the ops run on this thread inside ``with OpCost() as c``,
    per device (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops_by: Counter = Counter()
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.group_bytes: Counter = Counter()
        self.live = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._dtensor = _dtensor_types()

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by.values()))

    @property
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())

    # ------------------------------------------------------------ memory

    def _forget(self, nbytes: int, _ref=None) -> None:
        self.live -= nbytes

    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` (any nest of lists, tuples,
        dicts, DTensors and modules' parameters) as live from now until
        they die: the state a step starts from."""
        for t in _tensors(tensors):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if self._dtensor and isinstance(t, self._dtensor):
            t = t._local_tensor
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        if st in self._storages:
            return
        n = -(-st.nbytes() // _ALLOC_ROUND) * _ALLOC_ROUND
        self._storages[st] = weakref.ref(st, lambda r, n=n: self._forget(n))
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    # ------------------------------------------------------------ counts

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d_functional", "c10d"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in _tensors(out))
                rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += nbytes
                # the group's name is the last string argument
                group = [a for a in args if isinstance(a, str)][-1:]
                self.group_bytes[group[0] if group else ""] += nbytes
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops_by["matmul"] += flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            self.flops_by["elementwise"] += sum(t.numel() for t in _tensors(out))
        elif torch.Tag.reduction in func.tags:
            self.flops_by["reduce"] += sum(t.numel() for t in _tensors(args[:1]))
        if func.is_view or name in _FREE or ns == "prim":
            return
        outs = list(_tensors(out))
        if not outs:
            return
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(
            _nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor and any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented      # DTensor runs it and issues the local ops
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)     # DTensor's shape propagation
        # as FlopCounterMode: an op with no formula of its own is counted
        # through its decomposition where it has one
        if func._overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                       # the propagation's fake inputs
        self._count(func, args, kwargs, out)
        for t in outs:
            self._track(t)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "flops_by": dict(self.flops_by), "bytes": float(self.bytes),
                "collectives": {k: dict(v) for k, v in sorted(self.collectives.items())},
                "collective_bytes": self.collective_bytes, "peak_bytes": self.peak_bytes}
