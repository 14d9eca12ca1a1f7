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
