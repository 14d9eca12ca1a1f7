"""2D adaptive cubature engine: a chunked-LIFO bag of rectangles, on one
device.

The 1D bag engine (``bag_engine.py``) generalized to rectangles: four
float64 coordinate columns instead of two, a split produces four
quadrant children, and the push writes four chunk-wide windows at
stride n_split (each later window's tail lands on dead slots past the
children block). Each round pops a fixed-width chunk off the top,
evaluates it (``ops/rules2d.py``), adds the accepted cells' values to
the accumulator, and moves the split lanes to a dense prefix with one
stable sort of the meta word, so the rounds, the children's order and
the cell counts are the reference engine's.

The store is updated in place by :func:`rect_bag_step`; the counters
are Python ints held by the host loop, which reads one device value per
round (the split count) and two at the end (the accumulator and the
depth).

Across ranks (:func:`integrate_2d_sharded`, the reference's sharded 2D
engine on ``torch.distributed``, ``mesh.py``): a bag per rank, the
round's children dealt round-robin across the mesh in one collective
boundary (``mesh.strided_reshard``), whose gathered header (every rank's
child count and bag top) gives every rank the next global count and the
overflow flag, so the ranks take the same branch; leg snapshots and
:func:`resume_2d_sharded` in the reference's container.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.ops.rules2d import EVALS_PER_TASK_2D, eval_rect_batch
from ppls_tpu_torch.parallel.bag_engine import dyn_slice, dyn_update
from ppls_tpu_torch.parallel.mesh import (dealt_counts, device_store,
                                          spmd_entry, strided_reshard)
from ppls_tpu_torch.runtime.checkpoint import (load_family_checkpoint,
                                               save_family_checkpoint)
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device
from ppls_tpu_torch.utils.metrics import RunMetrics

# meta word: | accept/dead sort bit 30 | depth 13..0 | (single problem)
DEPTH_MASK_2D = (1 << 14) - 1
ACCEPT_BIT_2D = 1 << 30


@dataclasses.dataclass
class RectBag:
    lx: torch.Tensor          # (store,) f64
    rx: torch.Tensor
    ly: torch.Tensor
    ry: torch.Tensor
    meta: torch.Tensor        # (store,) i32 depth (+ transient sort bit)
    count: int                # live cells occupy [0, count)
    acc: torch.Tensor         # 0-dim f64 (deterministic order)
    tasks: int = 0
    splits: int = 0
    iters: int = 0
    max_depth: Optional[torch.Tensor] = None   # 0-dim i32
    overflow: bool = False


def _pop_eval_compact(s: RectBag, f: Callable, eps: float, rule: Rule,
                      chunk: int):
    """Pop, evaluate, accept and compact one chunk: returns (start,
    n_take, acc, max_depth, quads, ch_meta, split) where ``quads`` are
    the four sorted quadrant-child coordinate tuples (each valid on its
    first n_split lanes)."""
    n_take = min(s.count, chunk)
    start = s.count - n_take
    lx = dyn_slice(s.lx, start, chunk)
    rx = dyn_slice(s.rx, start, chunk)
    ly = dyn_slice(s.ly, start, chunk)
    ry = dyn_slice(s.ry, start, chunk)
    meta = dyn_slice(s.meta, start, chunk)
    active = torch.arange(chunk, dtype=torch.int32,
                          device=lx.device) < n_take

    value, _err, split = eval_rect_batch(lx, rx, ly, ry, f, eps, rule)
    split = split & active
    accept = active & ~split
    acc = s.acc + torch.sum(torch.where(accept, value, 0.0))
    depth = meta & DEPTH_MASK_2D
    max_depth = torch.maximum(
        s.max_depth, torch.max(torch.where(active, depth, 0)).to(torch.int32))

    # compaction: ONE stable sort of the key moves the split lanes to a
    # dense prefix in their original order, coordinates gathered by it
    skey = torch.where(split, meta, meta | ACCEPT_BIT_2D)
    skey, order = torch.sort(skey, stable=True)
    slx, srx, sly, sry = lx[order], rx[order], ly[order], ry[order]
    smx = 0.5 * (slx + srx)
    smy = 0.5 * (sly + sry)
    ch_meta = (skey & ~ACCEPT_BIT_2D) + 1
    #   k=0: [lx,mx]x[ly,my]   k=1: [mx,rx]x[ly,my]
    #   k=2: [lx,mx]x[my,ry]   k=3: [mx,rx]x[my,ry]
    quads = ((slx, smx, sly, smy), (smx, srx, sly, smy),
             (slx, smx, smy, sry), (smx, srx, smy, sry))
    return start, n_take, acc, max_depth, quads, ch_meta, split


def rect_bag_step(s: RectBag, f: Callable, eps: float, rule: Rule,
                  chunk: int, capacity: int, syncs: HostSyncs) -> RectBag:
    """One round: pop a chunk off the top, evaluate it, push the four
    quadrant windows at stride n_split (k = 0..3), accumulate. Updates
    the store in place and reads the split count (one host sync)."""
    start, n_take, acc, max_depth, quads, ch_meta, split = \
        _pop_eval_compact(s, f, eps, rule, chunk)
    n = int(syncs.pull(split.sum(dtype=torch.int32)))
    # the four windows overlap: window k's first n lanes survive, and the
    # last window whole, so one copy per column of their concatenation
    # leaves the store as the four writes in turn would
    cols = (s.lx, s.rx, s.ly, s.ry, s.meta)
    for j, col in enumerate(cols):
        vals = [q[j] for q in quads] if j < 4 else [ch_meta] * 4
        dyn_update(col, torch.cat([v[:n] for v in vals[:3]] + [vals[3]]),
                   start)
    new_count_raw = start + 4 * n
    return dataclasses.replace(
        s, count=min(new_count_raw, capacity), acc=acc,
        tasks=s.tasks + n_take, splits=s.splits + n,
        iters=s.iters + 1, max_depth=max_depth,
        overflow=s.overflow or new_count_raw > capacity)


def _run_rect_bag(state: RectBag, *, f: Callable, eps: float, rule: Rule,
                  chunk: int, capacity: int, max_iters: int,
                  syncs: HostSyncs) -> RectBag:
    """Rounds until the bag is empty, overflows or reaches
    ``max_iters`` rounds."""
    while state.count > 0 and not state.overflow and state.iters < max_iters:
        state = rect_bag_step(state, f, eps, rule, chunk, capacity, syncs)
    return state


@dataclasses.dataclass
class CubatureResult:
    area: float
    metrics: RunMetrics
    exact: Optional[float] = None
    host_syncs: int = 0
    mesh: Optional[dict] = None    # across ranks: transport, rank 0's calls

    @property
    def global_error(self) -> Optional[float]:
        return None if self.exact is None else abs(self.area - self.exact)


def seed_rect_state(bounds, chunk: int = 1 << 12,
                    capacity: int = 1 << 20, device="cuda") -> RectBag:
    """Build the 2D engine's seed state once, on ``device``, for reuse
    across repeated runs of the same problem (pass it as
    ``_state_override=`` to :func:`integrate_2d` / :func:`dispatch_2d`).
    The seed is pure input: each run walks its own copy."""
    dev = resolve_device(device)
    ax, bx, ay, by = (float(v) for v in bounds)
    if chunk > capacity:
        raise ValueError(f"chunk={chunk} exceeds capacity={capacity}")
    # 4 windows of slack: the k=3 window ends at start + 3*n_split + chunk
    # <= capacity + 4*chunk, so pushes never clamp
    store = capacity + 4 * chunk
    fx = 0.5 * (ax + bx)
    fy = 0.5 * (ay + by)

    def col(fill, first):
        c = torch.full((store,), fill, dtype=torch.float64, device=dev)
        c[0] = first
        return c

    return RectBag(
        lx=col(fx, ax), rx=col(fx, bx), ly=col(fy, ay), ry=col(fy, by),
        meta=torch.zeros(store, dtype=torch.int32, device=dev), count=1,
        acc=torch.zeros((), dtype=torch.float64, device=dev),
        max_depth=torch.zeros((), dtype=torch.int32, device=dev))


def _copy_rect_bag(s: RectBag) -> RectBag:
    """The same bag on fresh storage (a round updates its store in
    place)."""
    return dataclasses.replace(
        s, lx=s.lx.clone(), rx=s.rx.clone(), ly=s.ly.clone(),
        ry=s.ry.clone(), meta=s.meta.clone(), acc=s.acc.clone(),
        max_depth=s.max_depth.clone())


class RectDispatch(NamedTuple):
    """A 2D run queued by :func:`dispatch_2d`; redeem it with
    :func:`collect_2d`.

    The port's round loop reads the split count on the host every
    round, so a queued run cannot run ahead of the host as the
    reference's asynchronous dispatch does: ``run`` holds the validated
    and seeded run, and the collect walks it (on a copy of a shared
    ``_state_override``). ``t0`` is the dispatch time, so, as in the
    reference, a queued run's ``wall_time_s`` spans every run collected
    before it."""

    run: Callable
    t0: float
    rule: Rule
    capacity: int
    max_iters: int
    exact: Optional[float] = None


def dispatch_2d(f: Callable, bounds, eps: float,
                rule: Rule = Rule.SIMPSON,
                chunk: int = 1 << 12,
                capacity: int = 1 << 20,
                max_iters: int = 1 << 20,
                exact: Optional[float] = None,
                device="cuda",
                _state_override: Optional[RectBag] = None
                ) -> RectDispatch:
    """Validate and seed a 2D cubature run, to be walked by
    :func:`collect_2d`."""
    dev = resolve_device(device)
    if _state_override is None:
        state = seed_rect_state(bounds, chunk, capacity, device=dev)
    else:
        if chunk > capacity:
            raise ValueError(f"chunk={chunk} exceeds capacity={capacity}")
        state = _state_override
    kw = dict(f=f, eps=float(eps), rule=Rule(rule), chunk=int(chunk),
              capacity=int(capacity), max_iters=int(max_iters))

    def run():
        syncs = HostSyncs()
        s = state if _state_override is None else _copy_rect_bag(state)
        out = _run_rect_bag(s, syncs=syncs, **kw)
        acc, maxd = syncs.pull_arrays(out.acc, out.max_depth)
        return out, float(acc), int(maxd), syncs.n

    return RectDispatch(run=run, t0=time.perf_counter(), rule=Rule(rule),
                        capacity=int(capacity), max_iters=int(max_iters),
                        exact=exact)


def collect_2d(d: RectDispatch) -> CubatureResult:
    """Walk a queued :class:`RectDispatch`, validate, assemble."""
    out, area, maxd, n_syncs = d.run()
    wall = time.perf_counter() - d.t0
    if out.overflow:
        raise RuntimeError(f"rect bag overflowed capacity={d.capacity}")
    if out.count > 0:
        raise RuntimeError(f"max_iters={d.max_iters} exceeded")
    if not np.isfinite(area):
        raise FloatingPointError("2D cubature produced a non-finite area")
    metrics = RunMetrics(
        tasks=out.tasks, splits=out.splits, leaves=out.tasks - out.splits,
        rounds=out.iters, max_depth=maxd,
        integrand_evals=out.tasks * EVALS_PER_TASK_2D[Rule(d.rule)],
        wall_time_s=wall, n_chips=1, tasks_per_chip=[out.tasks])
    return CubatureResult(area=area, metrics=metrics, exact=d.exact,
                          host_syncs=n_syncs)


def integrate_2d(f: Callable, bounds, eps: float,
                 rule: Rule = Rule.SIMPSON,
                 chunk: int = 1 << 12,
                 capacity: int = 1 << 20,
                 max_iters: int = 1 << 20,
                 exact: Optional[float] = None,
                 device="cuda",
                 _state_override: Optional[RectBag] = None
                 ) -> CubatureResult:
    """Adaptively integrate ``f(x, y)`` over the rectangle
    ``bounds = (ax, bx, ay, by)`` with per-cell tolerance ``eps``, on
    ``device`` (CUDA by default; without a card this raises unless
    ``device="cpu"``)."""
    return collect_2d(dispatch_2d(
        f, bounds, eps, rule=rule, chunk=chunk, capacity=capacity,
        max_iters=max_iters, exact=exact, device=device,
        _state_override=_state_override))


# ---------------------------------------------------------------------------
# The rectangle bag across devices
# ---------------------------------------------------------------------------


def _shard_rect_round(mesh, s: RectBag, f: Callable, eps: float, rule: Rule,
                      chunk: int, capacity: int, fx: float, fy: float):
    """One round across ranks: the local pop and evaluation, the four
    quadrant blocks compacted to one dense prefix, then every rank's
    children dealt across the mesh (``mesh.strided_reshard``) and pushed
    on the local top. Returns ``(state, glob)``: the rank's new state,
    whose ``overflow`` is replicated, and the new global cell count, both
    computed from the deal's gathered (children, start) header on every
    rank."""
    start, n_take, acc, max_depth, quads, ch_meta, split = \
        _pop_eval_compact(s, f, eps, rule, chunk)
    n = int(mesh.syncs.pull(split.sum(dtype=torch.int32)))
    # (4 * chunk,) child columns: the valid first n lanes of the four
    # quadrant blocks in block order, then their tails (the reference's
    # one stable sort of the concatenated blocks by validity)
    cols = []
    for j in range(5):
        blocks = [q[j] for q in quads] if j < 4 else [ch_meta] * 4
        cols.append(torch.cat([b[:n] for b in blocks]
                              + [b[n:] for b in blocks]))
    tk, _mine, total, header = strided_reshard(
        mesh, cols, 4 * n, (fx, fx, fy, fy, 0), 4 * chunk, extra=(start,))
    for col, t in zip((s.lx, s.rx, s.ly, s.ry, s.meta), tk):
        dyn_update(col, t, start)
    new_raw = header[:, 1] + dealt_counts(total, mesh.size, 4 * chunk)
    glob = int(np.minimum(new_raw, capacity).sum())
    out = dataclasses.replace(
        s, count=int(min(new_raw[mesh.rank], capacity)), acc=acc,
        tasks=s.tasks + n_take, splits=s.splits + n, iters=s.iters + 1,
        max_depth=max_depth,
        overflow=s.overflow or bool(np.any(new_raw > capacity)))
    return out, glob


def _run_sharded_2d(mesh, s: RectBag, *, f: Callable, eps: float, rule: Rule,
                    chunk: int, capacity: int, max_iters: int,
                    stop_iters: int, fx: float, fy: float) -> RectBag:
    """The reference's ``_build_sharded_2d_run`` loop on one rank: rounds
    while the global cell count is positive, nothing overflowed and
    ``iters`` (the same on every rank) is below ``max_iters`` and the
    leg's ``stop_iters``."""
    glob = mesh.psum_host([s.count])[0]
    while (glob > 0 and not s.overflow and s.iters < max_iters
           and s.iters < stop_iters):
        s, glob = _shard_rect_round(mesh, s, f, eps, rule, chunk, capacity,
                                    fx, fy)
    return s


def _sharded_2d_identity(f: Callable, eps: float, bounds, n_dev: int,
                         rule: Rule) -> dict:
    from ppls_tpu_torch.runtime.checkpoint import (_family_identity,
                                                   engine_name)

    # the integrand's module-qualified name; anonymous callables share a
    # name, the registry's 2D integrands all differ
    fname = (getattr(f, "__module__", "?") + "."
             + getattr(f, "__qualname__", getattr(f, "__name__", "f")))
    ident = _family_identity(engine_name("sharded-2d", rule), fname, eps,
                             1, np.zeros(0),
                             np.asarray(bounds, dtype=np.float64))
    ident["n_dev"] = n_dev
    return ident


def _spawnable_2d(f, n_devices, device):
    """``f``, or its registered name when a world of several ranks must be
    spawned: the ranks look the name up again (a lambda does not pickle).
    Raises ``ValueError`` naming an unregistered integrand then."""
    import torch.distributed as dist

    from ppls_tpu_torch.models.integrands import INTEGRANDS_2D
    from ppls_tpu_torch.parallel.mesh import default_world

    if isinstance(f, str) or dist.is_initialized():
        return f
    n = default_world(device) if n_devices is None else int(n_devices)
    if n <= 1:
        return f
    for name, entry in INTEGRANDS_2D.items():
        if entry.fn is f:
            return name
    raise ValueError(
        f"integrand {getattr(f, '__qualname__', f)!r} is not registered "
        f"(models/integrands.py register_integrand_2d); a world of {n} "
        f"ranks looks its integrand up by name")


def integrate_2d_sharded(f: Callable, bounds, eps: float,
                         rule: Rule = Rule.SIMPSON,
                         chunk: int = 1 << 10,
                         capacity: int = 1 << 18,
                         max_iters: int = 1 << 20,
                         exact: Optional[float] = None,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 256, *,
                         n_devices: Optional[int] = None, device="cuda",
                         mesh=None,
                         _state_override=None,
                         _totals_override: Optional[dict] = None,
                         _crash_after_legs: Optional[int] = None
                         ) -> CubatureResult:
    """2D cubature across ranks: a rectangle bag per rank with the
    children dealt round-robin every round (refinement clustered in one
    rank's subdomain spreads out), the loop ending when the sum of the
    bag counts is zero, and the ranks' accumulators added in rank order
    on the host. ``chunk`` and ``capacity`` are per rank; the cell counts
    equal :func:`integrate_2d`'s (split decisions do not depend on
    placement). ``n_devices`` ranks run on ``device`` (CUDA by default;
    ``"cpu"`` runs gloo ranks); ``mesh.launch`` starts them unless the
    call is made inside a process group. ``f`` may be a registered 2D
    integrand's name; a world that must be spawned needs ``f`` to be
    registered.

    With ``checkpoint_path`` the run goes in legs of ``checkpoint_every``
    rounds, each ending in a snapshot of every rank's live bag prefix,
    written by rank 0 (the reference's container, the mesh size in its
    identity); :func:`resume_2d_sharded` continues it bit-identically."""
    return _integrate_2d_sharded(
        _spawnable_2d(f, n_devices, device), bounds, eps, rule, chunk,
        capacity, max_iters, exact, checkpoint_path, checkpoint_every,
        n_devices=n_devices, device=device, mesh=mesh,
        _state_override=_state_override, _totals_override=_totals_override,
        _crash_after_legs=_crash_after_legs)


@spmd_entry
def _integrate_2d_sharded(f, bounds, eps, rule, chunk, capacity, max_iters,
                          exact, checkpoint_path, checkpoint_every, *, mesh,
                          _state_override=None, _totals_override=None,
                          _crash_after_legs=None) -> CubatureResult:
    from ppls_tpu_torch.models.integrands import get_integrand_2d

    if isinstance(f, str):
        f = get_integrand_2d(f).fn
    n_dev, r, dev = mesh.size, mesh.rank, mesh.device
    ax, bx, ay, by = (float(v) for v in bounds)
    if chunk > capacity:
        raise ValueError(f"chunk={chunk} exceeds capacity={capacity}")
    store = capacity + 4 * chunk
    fx = 0.5 * (ax + bx)
    fy = 0.5 * (ay + by)
    if _state_override is None:
        # one root rectangle on rank 0, the fill everywhere else
        first = r == 0
        cols = [device_store(store, fill, [v] if first else [], device=dev)
                for fill, v in ((fx, ax), (fx, bx), (fy, ay), (fy, by))]
        cols.append(torch.zeros(store, dtype=torch.int32, device=dev))
        count0 = int(first)
    else:
        *cols, count0 = _state_override
    acc0, ctr = 0.0, dict(tasks=0, splits=0, iters=0, maxd=0)
    if _totals_override is not None:
        acc0 = float(np.asarray(_totals_override["acc_per_chip"])[r])
        for k in ("tasks", "splits", "iters", "maxd"):
            ctr[k] = int(_totals_override["pc_" + k][r])
    s = RectBag(lx=cols[0], rx=cols[1], ly=cols[2], ry=cols[3],
                meta=cols[4], count=int(count0),
                acc=torch.tensor(acc0, dtype=torch.float64, device=dev),
                tasks=ctr["tasks"], splits=ctr["splits"], iters=ctr["iters"],
                max_depth=torch.tensor(ctr["maxd"], dtype=torch.int32,
                                       device=dev))
    kw = dict(f=f, eps=float(eps), rule=Rule(rule), chunk=int(chunk),
              capacity=int(capacity), max_iters=int(max_iters), fx=fx,
              fy=fy)
    t0 = time.perf_counter()
    legs = 0
    while True:
        # iters advances in lockstep on every rank: the leg end agrees
        leg_end = (s.iters + int(checkpoint_every) if checkpoint_path
                   else int(max_iters))
        s = _run_sharded_2d(mesh, s, stop_iters=leg_end, **kw)
        left = mesh.psum_host([s.count])[0]
        finished = left == 0 or s.overflow
        if checkpoint_path is None or finished:
            break
        _snapshot_2d(mesh, checkpoint_path, _sharded_2d_identity(
            f, float(eps), bounds, n_dev, Rule(rule)), s, store)
        legs += 1
        if _crash_after_legs is not None and legs >= _crash_after_legs:
            raise RuntimeError(
                f"simulated crash after {legs} legs (test hook)")
        # snapshot before the max_iters exit: a resume with a larger
        # max_iters continues instead of replaying
        if s.iters >= max_iters:
            break
    wall = time.perf_counter() - t0

    if s.overflow:
        raise RuntimeError(
            f"sharded rect bag overflowed per-chip capacity={capacity}")
    if left > 0:
        raise RuntimeError(f"max_iters={max_iters} exceeded")
    from ppls_tpu_torch.parallel.sharded_bag import gather_rows
    maxd = int(mesh.syncs.pull(s.max_depth))
    pc = mesh.gather_host([s.tasks, s.splits, s.iters, maxd])
    acc = gather_rows(mesh, s.acc)
    # the deterministic cross-rank reduction on the host, in rank order
    area = float(np.sum(np.asarray(acc, dtype=np.float64)))
    if not np.isfinite(area):
        raise FloatingPointError("sharded 2D produced a non-finite area")
    if r == 0:
        from ppls_tpu_torch.parallel.bag_engine import _clear_snapshot
        _clear_snapshot(checkpoint_path)
    tasks_per_chip = [int(t) for t in pc[:, 0]]
    tasks = sum(tasks_per_chip)
    splits = int(pc[:, 1].sum())
    metrics = RunMetrics(
        tasks=tasks, splits=splits, leaves=tasks - splits,
        rounds=int(pc[:, 2].max()), max_depth=int(pc[:, 3].max()),
        integrand_evals=tasks * EVALS_PER_TASK_2D[Rule(rule)],
        wall_time_s=wall, n_chips=n_dev, tasks_per_chip=tasks_per_chip)
    return CubatureResult(area=area, metrics=metrics, exact=exact,
                          host_syncs=mesh.syncs.n, mesh=mesh.record())


def _snapshot_2d(mesh, path: str, identity: dict, s: RectBag,
                 store: int) -> None:
    """Gather every rank's live prefix, accumulator and counters; rank 0
    writes the snapshot (the reference's columns and totals), then every
    rank waits for it."""
    from ppls_tpu_torch.parallel.sharded_bag import gather_prefix, gather_rows

    counts, _b, (lx, rx, ly, ry, meta) = gather_prefix(
        mesh, (s.lx, s.rx, s.ly, s.ry, s.meta), s.count, store)
    maxd = int(mesh.syncs.pull(s.max_depth))
    pc = mesh.gather_host([s.tasks, s.splits, s.iters, maxd])
    acc = gather_rows(mesh, s.acc)
    if mesh.rank == 0:
        save_family_checkpoint(
            path, identity=identity,
            bag_cols={"lx": lx, "rx": rx, "ly": ly, "ry": ry, "meta": meta,
                      "counts": counts},
            count=int(np.sum(counts)), acc=acc,
            totals={"pc_tasks": pc[:, 0].tolist(),
                    "pc_splits": pc[:, 1].tolist(),
                    "pc_iters": pc[:, 2].tolist(),
                    "pc_maxd": pc[:, 3].tolist(),
                    "acc_per_chip": acc.tolist()})
    mesh.barrier()


def resume_2d_sharded(path: str, f: Callable, bounds, eps: float,
                      rule: Rule = Rule.SIMPSON,
                      chunk: int = 1 << 10,
                      capacity: int = 1 << 18,
                      max_iters: int = 1 << 20,
                      exact: Optional[float] = None,
                      checkpoint_every: int = 256, *,
                      n_devices: Optional[int] = None, device="cuda",
                      mesh=None) -> CubatureResult:
    """Continue an interrupted :func:`integrate_2d_sharded` run from its
    last leg snapshot (identity-checked: integrand name, bounds, eps,
    rule, mesh size), bit-identical to the uninterrupted run."""
    return _resume_2d_sharded(
        path, _spawnable_2d(f, n_devices, device), bounds, eps, rule, chunk,
        capacity, max_iters, exact, checkpoint_every, n_devices=n_devices,
        device=device, mesh=mesh)


@spmd_entry
def _resume_2d_sharded(path, f, bounds, eps, rule, chunk, capacity,
                       max_iters, exact, checkpoint_every, *,
                       mesh) -> CubatureResult:
    from ppls_tpu_torch.models.integrands import get_integrand_2d

    if isinstance(f, str):
        f = get_integrand_2d(f).fn
    identity = _sharded_2d_identity(f, float(eps), bounds, mesh.size,
                                    Rule(rule))
    bag_cols, _count, acc, totals = load_family_checkpoint(path, identity)
    store = capacity + 4 * chunk
    counts = np.asarray(bag_cols["counts"], dtype=np.int32)
    b = bag_cols["lx"].shape[1]
    if b > store or int(counts.max(initial=0)) > store:
        raise ValueError(
            f"resume sizing mismatch: snapshot prefix width {b} does "
            f"not fit the store {store} from this call's chunk/capacity;"
            f" resume with the original run's sizing parameters")
    ax, bx, ay, by = (float(v) for v in bounds)
    fx = 0.5 * (ax + bx)
    fy = 0.5 * (ay + by)
    r, dev = mesh.rank, mesh.device
    # only the saved prefixes move to the device
    state = (device_store(store, fx, bag_cols["lx"][r], device=dev),
             device_store(store, fx, bag_cols["rx"][r], device=dev),
             device_store(store, fy, bag_cols["ly"][r], device=dev),
             device_store(store, fy, bag_cols["ry"][r], device=dev),
             device_store(store, 0, bag_cols["meta"][r], torch.int32, dev),
             int(counts[r]))
    totals = dict(totals)
    # the binary-exact npz accumulator, not the JSON round trip
    totals["acc_per_chip"] = np.asarray(acc)
    return _integrate_2d_sharded(
        f, bounds, eps, rule, chunk, capacity, max_iters, exact, path,
        checkpoint_every, mesh=mesh, _state_override=state,
        _totals_override=totals)
