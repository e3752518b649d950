"""Reseeding plan cache: the serving tier's host-side fast path (port of
``repro.serve.plancache``).

A plan is mostly *structure* (chunk grids, candidate-pair lists, decode
parameters), and structure depends only on the spec's shape (its family
and every field but ``seed``), the virtual PE count and the key impl.
Every emitter attaches a ``reseed_fn`` that recomputes the
seed-dependent columns (keys, counts) against the cached structure, so
many seeds of one shape cost one cold emission plus reseeds.  A reseeded
plan equals the cold emission for its seed field by field
(tests/test_torch_serve.py, every family).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Tuple

from .. import obs


def spec_shape(spec) -> Tuple:
    """Hashable identity of everything about ``spec`` except its seed.

    Two specs with equal shape emit plans sharing all structure tables;
    only the key and count columns differ, which ``reseed`` recomputes.
    """
    if not dataclasses.is_dataclass(spec):
        raise TypeError(f"spec {type(spec).__name__} is not a dataclass")
    return (type(spec).__name__,) + tuple(
        (f.name, getattr(spec, f.name))
        for f in dataclasses.fields(spec) if f.name != "seed")


class PlanCache:
    """LRU plan cache keyed by ``(spec_shape, P, rng_impl)``.

    A hit returns ``cached_plan.reseed(spec.seed)``; a miss emits cold
    through ``spec.plan`` and stores the result (which carries its reseed
    emitter).  Counters give the hit, miss and eviction totals of the
    service's stats.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def plan(self, spec, P: int, rng_impl: str, device=None):
        """The plan ``spec.plan(P, rng_impl=..., device=...)`` would emit,
        through a reseed when the shape is warm.  ``device`` is where RDG's
        planning runs (its reseed reruns the triangulations there)."""
        key = (spec_shape(spec), int(P), rng_impl)
        cached = self._entries.get(key)
        if cached is not None:
            try:
                out = cached.reseed(spec.seed)
            except ValueError:
                # plan carries no reseed emitter: refresh the entry cold
                cached = None
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                obs.event("plan_cache", hit=True, shape=key[0][0])
                return out
        self.misses += 1
        obs.event("plan_cache", hit=False, shape=key[0][0])
        plan = spec.plan(P, rng_impl=rng_impl, device=device)
        self._entries[key] = plan
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return plan

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._entries)}
