"""The registered-program inventory Pass 1 runs (port of
``repro.analyze.programs``).

Every device program the port can execute is enumerated here: all eight
spec families' plans (ChunkPlan for the sampled families, PairPlan +
PointPlan for the geometric ones), each run through *both* runtime
paths (the materializing :func:`~repro_torch.distrib.runtime.run` and
the ``wave`` path, :func:`~repro_torch.distrib.runtime.stream_waves`),
the serving tier's packed slabs (:func:`~repro_torch.distrib.runtime.
run_slab`), and the kernel entry points whose contracts the engine paths
do not reach (the float32 pairmask kernel, the Delaunay triangulation).
The specs are the reference's tiny ones (n = 64): a contract violation
is a property of the program's structure, so it shows at n = 64 as at
n = 2^30.

The port lowers nothing: a case *runs* its program on the given device
under the op trace of :mod:`~repro_torch.analyze.opscan` (kernel entry
points opaque, except in a kernel case, which traces its kernel's plain
version on the CPU) and keeps its outputs, so that a card's run can be
held against the CPU's.  Each case carries a
:class:`~repro_torch.analyze.opscan.Contract`: the generator contract
for chunk programs, the recompute contract for pair and point programs
(in the port the two are the same), the float32 contract for the
pairmask kernel.  :func:`scan_case` attaches the launches of each
kernel and their analytic cost (:mod:`repro_torch.launch.cost`, from
the launches' shapes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .opscan import (Contract, FLOAT32_KERNEL_CONTRACT, GENERATOR_CONTRACT,
                     RECOMPUTE_CONTRACT, ScanReport, opaque, scan_census, trace)

FAMILIES = ("gnm", "gnp", "ba", "rmat", "sbm", "rgg", "rhg", "rdg", "serve")

# modes a plan runs through: the materializing run and the wave stream
MODES = ("run", "wave")

DEFAULT_P = 4
DEFAULT_BATCH = 4


def small_specs() -> Dict[str, object]:
    """One tiny spec per family: the reference's, at the same n."""
    from ..api import BA, GNM, GNP, RDG, RGG, RHG, RMAT, SBM

    n = 64
    return {
        "gnm": GNM(n=n, m=2 * n, seed=7, chunks=8),
        "gnp": GNP(n=n, p=0.05, seed=7, chunks=8),
        "ba": BA(n=n, d=2, seed=7),
        "rmat": RMAT(log_n=6, m=2 * n, seed=7),
        "sbm": SBM(n=n, blocks=2, p_in=0.2, p_out=0.02, seed=7),
        "rgg": RGG(n=n, radius=0.25, seed=7, chunks=8),
        "rhg": RHG(n=n, avg_deg=4.0, gamma=2.7, seed=7),
        "rdg": RDG(n=32, seed=7, chunks=8),
    }


@dataclass(frozen=True)
class ProgramCase:
    """One runnable program: a plan (or kernel) on ``D`` mesh rows, with
    its contract.  ``run(device)`` executes it and returns its outputs
    (tensors); ``opaque`` is off for a kernel case."""
    name: str               # e.g. "rgg/pair/wave"
    family: str
    plan_kind: str          # chunk | point | pair | kernel
    mode: str               # run | wave | slab | call
    contract: Contract
    run: Callable[[torch.device], tuple]
    signature: tuple = ()
    opaque: bool = True
    device: Optional[torch.device] = None   # a mesh row's case runs on its row's device


def _plan_kind(plan) -> str:
    from ..distrib import engine

    return {engine.ChunkPlan: "chunk", engine.PairPlan: "pair",
            engine.PointPlan: "point"}[type(plan)]


def _run_outputs(plan, dev, mesh):
    from ..distrib import runtime

    payload, valid = runtime.run(plan, dev, check=False, mesh=mesh)
    return payload, valid


def _wave_outputs(plan, dev, mesh, batch: int):
    from ..distrib import runtime

    out = []
    for wave in runtime.stream_waves(plan, batch=batch, device=dev, mesh=mesh):
        out += [wave.payload, wave.valid]
    return tuple(out)


def _row_outputs(plan, mesh, d: int, mode: str, batch: int):
    """Row ``d``'s outputs of a plan on a :class:`LocalMesh`: its slice run
    on its device, or its batches of the mesh's waves, alone."""
    from ..distrib import runtime

    if mode == "run":
        return runtime.run_rows(plan, mesh, check=False, only=(d,))[d]
    out = []
    for wave in runtime._local_waves(plan, mesh, batch, 2, False, only=(d,)):
        if wave.rows[d] is not None:
            out += [wave.payload[d], wave.valid[d]]
    return tuple(out)


def _plan_cases(family: str, spec, P: int, batch: int, mesh=None,
                device="cpu") -> Iterator[ProgramCase]:
    """The spec's programs on ``mesh``: a row count D, a :class:`LocalMesh`
    of several rows, on which each row's program is a case of its own
    (``.../row<d>``), run on its row's device, or a world, whose rank
    runs the slice of its own PEs on its own rows (one case a row on a
    rank of several cards, named by its world row ``r k + d``)."""
    from ..distrib.engine import slice_plan
    from ..distrib.world import LocalMesh, World

    local, D, pes, row0 = None, 1, None, 0
    if isinstance(mesh, World):
        pes, row0 = mesh.pes(P), mesh.row_range()[0]
        local = mesh.local() if mesh.cards > 1 else None
    elif isinstance(mesh, LocalMesh):
        local = mesh
    elif mesh is not None:
        D = int(mesh)
    plans: List[Tuple[str, object]] = []
    plan = spec.plan(P, device=device)
    plans.append((_plan_kind(plan), plan))
    point_plan = getattr(spec, "point_plan", None)
    if point_plan is not None:
        plans.append(("point", point_plan(P, device=device)))
    if pes is not None:
        plans = [(kind, slice_plan(p, *pes)) for kind, p in plans]

    for kind, p in plans:
        contract = GENERATOR_CONTRACT if kind == "chunk" else RECOMPUTE_CONTRACT
        for mode in MODES:
            name = f"{family}/{kind}/{mode}"
            if local is not None:
                for d in range(local.size):
                    yield ProgramCase(
                        name=f"{name}/row{row0 + d}", family=family, plan_kind=kind, mode=mode,
                        contract=contract, signature=p.signature(), device=local.devices[d],
                        run=(lambda dev, p=p, d=d, mode=mode:
                             _row_outputs(p, local, d, mode, batch)))
                continue
            if mode == "run":
                run = (lambda dev, p=p: _run_outputs(p, dev, D))
            else:
                run = (lambda dev, p=p: _wave_outputs(p, dev, D, batch))
            yield ProgramCase(
                name=name, family=family, plan_kind=kind,
                mode=mode, contract=contract, run=run, signature=p.signature())


def _serve_cases(P: int, mesh=None, device="cpu") -> Iterator[ProgramCase]:
    """The serving tier's packed mixed-request slab programs: a chunk
    slab mixing G(n,m) and BA rows under the generator contract, and a
    pair slab mixing RGG (GEOM_TORUS) and RHG (GEOM_HYP) rows under the
    recompute contract, exactly what ``runtime.run_slab`` executes (and
    ``check``-asserts) when serving."""
    from ..api import BA, GNM, RGG, RHG
    from ..distrib import runtime
    from ..serve.scheduler import Scheduler
    from ..serve.sinks import Sink

    n = 64
    D = runtime.mesh_size(mesh)
    mixes = {
        "chunk": (GENERATOR_CONTRACT,
                  [GNM(n=n, m=2 * n, seed=7, chunks=8),
                   BA(n=n, d=2, seed=9)]),
        "pair": (RECOMPUTE_CONTRACT,
                 [RGG(n=n, radius=0.25, seed=7, chunks=8),
                  RHG(n=n, avg_deg=4.0, gamma=2.7, seed=9)]),
    }
    for kind, (contract, specs) in mixes.items():
        sch = Scheduler(D, slab_batch=4, device=device, check=False)
        for spec in specs:
            sch.enqueue(spec.plan(P, device=device), Sink())
        prog, valid, rows = sch.peek_slab()

        def run(dev, prog=prog, valid=valid, rows=rows):
            return runtime.run_slab(prog.slot_fn, prog.signature(), valid, rows, dev,
                                    check=False, **prog.slot_kwargs(rows))

        yield ProgramCase(
            name=f"serve/{kind}/slab", family="serve", plan_kind=kind,
            mode="slab", contract=contract, run=run, signature=prog.signature())


def _kernel_cases() -> Iterator[ProgramCase]:
    """The kernel entry points.

    The pairmask euclid tile is declared float32 (float64 is a violation:
    the TORUS r^2 test is pinned so engine and kernel agree bit for bit).
    The batched Delaunay triangulation is float64 *by design* (its Cramer
    circumsphere predicate must match the engine's GEOM_CERT re-check bit
    for bit), so it carries the recompute contract.  On the CPU a case
    runs the kernel's plain version with nothing opaque (the
    triangulation with ``read_back=False``: its trips read nothing back);
    on a card, the kernel."""
    from ..kernels.delaunay import ops as D
    from ..kernels.delaunay.ref import triangulate_ref

    # the plain version counted as the kernel's launch, as the entry point
    # counts it, but with trips that read nothing back
    plain_dt = opaque("triangulate")(triangulate_ref)
    from ..kernels.pairmask.ops import pair_mask

    def euclid(dev):
        rng = np.random.default_rng(11)
        a = torch.from_numpy(rng.random((128, 8), np.float32)).to(dev)
        b = torch.from_numpy(rng.random((128, 8), np.float32)).to(dev)
        return (pair_mask(a, b, 0.0625, tile="euclid", dim=2),)

    yield ProgramCase(
        name="kernels/pairmask/euclid", family="kernels", plan_kind="kernel",
        mode="call", contract=FLOAT32_KERNEL_CONTRACT, run=euclid,
        signature=("pairmask", "euclid", 128, 8), opaque=False)

    for dim, n in ((2, 64), (3, 64)):
        def dt(dev, dim=dim, n=n):
            rng = np.random.default_rng(12 + dim)
            pts = torch.from_numpy(rng.random((4, n, dim))).to(dev)
            # from numpy: a list made on the card is copied outside dispatch
            cnt = torch.from_numpy(np.array([n, n - 9, 0, n // 2])).to(dev)
            kw = dict(dim=dim, num_simplices=D.simplex_capacity(n, dim),
                      cavity=D.cavity_capacity(dim), group=D.group_size(dim))
            if dev.type == "cpu":
                return plain_dt(pts, cnt, read_back=False, **kw)
            return D.triangulate(pts, cnt, **kw)

        yield ProgramCase(
            name=f"kernels/delaunay/triangulate{dim}d", family="kernels",
            plan_kind="kernel", mode="call", contract=RECOMPUTE_CONTRACT, run=dt,
            signature=("delaunay", "triangulate", dim, n), opaque=False)


def iter_programs(
    families: Optional[Sequence[str]] = None,
    P: int = DEFAULT_P,
    batch: int = DEFAULT_BATCH,
    mesh=None,
    kernels: bool = True,
    device="cpu",
) -> Iterator[ProgramCase]:
    """Yield every registered program case (filtered by ``families``);
    plans are built on ``device`` (RDG's planning triangulates there)."""
    want = list(families) if families else list(FAMILIES)
    unknown = [f for f in want if f not in FAMILIES + ("kernels",)]
    if unknown:
        raise ValueError(f"unknown families {unknown}; know {FAMILIES}")
    specs = small_specs()
    for family in want:
        if family == "kernels":
            continue
        if family == "serve":
            yield from _serve_cases(P, mesh, device)
            continue
        yield from _plan_cases(family, specs[family], P, batch, mesh, device)
    if kernels and (families is None or "kernels" in want):
        yield from _kernel_cases()


@dataclass
class ProgramReport:
    """Pass-1 verdict + analytic cost of one program: ``flops`` are the
    operations of its kernel launches (integer and float, each kind at
    its own peak in :mod:`repro_torch.launch.roofline`), ``bytes`` the
    bytes they move, from the launches' shapes.  ``outputs`` (not in the
    JSON) are the program's outputs on the host."""
    name: str
    plan_kind: str
    mode: str
    signature: tuple
    scan: ScanReport
    flops: Optional[float] = None
    bytes: Optional[float] = None
    error: Optional[str] = None
    device: str = "cpu"
    seconds: Optional[float] = None
    outputs: tuple = field(default=(), repr=False)

    @property
    def ok(self) -> bool:
        return self.error is None and self.scan.ok

    @property
    def launches(self) -> Dict[str, int]:
        return self.scan.launches

    def to_json(self) -> dict:
        out = {
            "name": self.name,
            "plan_kind": self.plan_kind,
            "mode": self.mode,
            "signature": [str(s) for s in self.signature],
            "flops": self.flops,
            "bytes": self.bytes,
            "device": self.device,
            "seconds": self.seconds,
            "ok": self.ok,
        }
        out.update(self.scan.to_json())
        if self.error:
            out["error"] = self.error
        return out


def scan_case(case: ProgramCase, with_cost: bool = True, device="cpu",
              sync_debug: bool = True) -> ProgramReport:
    """Run one case on ``device`` under the op trace (on a card under
    ``set_sync_debug_mode("error")`` too, unless ``sync_debug`` is off)
    and scan its census; optionally price its launches."""
    import time

    dev = torch.device(case.device if case.device is not None else device)
    calls: list = []
    try:
        t0 = time.perf_counter()
        with trace(opaque=case.opaque, sync_debug=sync_debug and dev.type == "cuda",
                   calls=calls) as census:
            out = case.run(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        scan = scan_census(census, case.contract)
    except Exception as e:  # the program itself failing is a finding, not a crash
        return ProgramReport(case.name, case.plan_kind, case.mode, case.signature,
                             ScanReport(), error=f"{e!r}", device=dev.type)
    outputs = tuple(t.cpu() for t in out)
    flops = nbytes = None
    if with_cost:
        from ..launch import cost as _cost

        total = _cost.ZERO
        try:
            for name, args, kwargs in calls:
                total = total + _cost.launch_cost(name, args, kwargs)
        except Exception as e:
            return ProgramReport(case.name, case.plan_kind, case.mode, case.signature,
                                 scan, error=f"cost: {e!r}", device=dev.type,
                                 outputs=outputs)
        flops, nbytes = total.ops, total.bytes
    return ProgramReport(case.name, case.plan_kind, case.mode, case.signature, scan,
                         flops=flops, bytes=nbytes, device=dev.type, seconds=seconds,
                         outputs=outputs)


def scan_programs(
    families: Optional[Sequence[str]] = None,
    P: int = DEFAULT_P,
    batch: int = DEFAULT_BATCH,
    mesh=None,
    with_cost: bool = True,
    kernels: bool = True,
    device="cpu",
) -> List[ProgramReport]:
    """Pass 1 over the whole registered inventory, on ``device``."""
    return [scan_case(c, with_cost=with_cost, device=device)
            for c in iter_programs(families, P=P, batch=batch, mesh=mesh,
                                   kernels=kernels, device=device)]


def scan_spec(spec, P: int = DEFAULT_P, *, mesh=None, batch: int = DEFAULT_BATCH,
              with_cost: bool = False, name: str = "spec", device="cpu"
              ) -> List[ProgramReport]:
    """Pass 1 for one user-supplied spec (the backend of
    :func:`repro_torch.api.verify_contracts`): every plan the spec emits,
    through both runtime paths."""
    return [scan_case(c, with_cost=with_cost, device=device)
            for c in _plan_cases(name, spec, P, batch, mesh, device)]
