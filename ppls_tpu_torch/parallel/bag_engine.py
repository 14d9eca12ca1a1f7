"""Device-resident task bag with chunked LIFO processing: the f64
family engine, and the walker's breed and drain.

The bag is a dense store of intervals plus a live count; each round
pops a fixed-width chunk off the top, evaluates it in float64, credits
accepted leaves to their family with an order-independent or
fixed-order segment sum, and pushes the split children back on top with
one stable sort. Every task carries its family id and its own theta, so
independent problems share one bag.

Unlike the reference, whose state is immutable inside one compiled
loop, the store tensors here are updated in place by :func:`bag_step`
(the counters are Python ints held by the host loop; each round reads
one device value, the split count).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.ops.reduction import segment_sum_auto
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK, eval_batch
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device
from ppls_tpu_torch.utils.metrics import RunMetrics

# Meta word layout (int32): | accept/dead sort bit 30 | fam 29..14 | depth 13..0 |
DEPTH_BITS = 14
DEPTH_MASK = (1 << DEPTH_BITS) - 1
ACCEPT_BIT = 1 << 30
MAX_FAMILIES = 1 << 16


@dataclasses.dataclass
class BagState:
    bag_l: torch.Tensor       # (store,) f64 left endpoints
    bag_r: torch.Tensor       # (store,) f64 right endpoints
    bag_th: torch.Tensor      # (store,) f64 per-task integrand parameter
    bag_meta: torch.Tensor    # (store,) i32: fam << DEPTH_BITS | depth
    count: int                # live entries occupy [0, count)
    acc: torch.Tensor         # (n_families,) f64 area accumulator
    tasks: int = 0
    splits: int = 0
    iters: int = 0
    max_depth: Optional[torch.Tensor] = None   # 0-dim i32 (device)
    overflow: bool = False

    def fresh_counters(self) -> "BagState":
        """The same store and count with the accumulator and counters
        zeroed (the next cycle's input)."""
        return dataclasses.replace(
            self, acc=torch.zeros_like(self.acc), tasks=0, splits=0,
            iters=0, max_depth=torch.zeros_like(self.max_depth))


def dyn_slice(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``x[start:start+size]`` with the start clamped so the window fits
    (the semantics of ``lax.dynamic_slice``); a view."""
    s = min(max(int(start), 0), x.shape[0] - size)
    return x[s:s + size]


def dyn_update(x: torch.Tensor, val: torch.Tensor, start: int) -> None:
    """In-place ``x[start:start+len(val)] = val`` with the start clamped
    so the window fits (``lax.dynamic_update_slice``)."""
    n = val.shape[0]
    s = min(max(int(start), 0), x.shape[0] - n)
    x[s:s + n] = val


def bag_step(state: BagState, f_theta: Callable, eps: float, rule: Rule,
             chunk: int, capacity: int, syncs: HostSyncs) -> BagState:
    """Pop a chunk off the bag top, evaluate, push children, accumulate."""
    n_take = min(state.count, chunk)
    start = state.count - n_take
    dev = state.bag_l.device

    l = dyn_slice(state.bag_l, start, chunk)
    r = dyn_slice(state.bag_r, start, chunk)
    th = dyn_slice(state.bag_th, start, chunk)
    meta = dyn_slice(state.bag_meta, start, chunk)
    lane = torch.arange(chunk, dtype=torch.int32, device=dev)
    active = lane < n_take

    fam = meta >> DEPTH_BITS
    depth = meta & DEPTH_MASK
    value, _err, split = eval_batch(l, r, lambda x: f_theta(x, th), eps,
                                    rule)
    split = split & active
    accept = active & ~split

    leaf = torch.where(accept, value, 0.0)
    m = state.acc.shape[0]
    acc = state.acc + segment_sum_auto(fam, leaf, m, chunk)
    max_depth = torch.maximum(
        state.max_depth,
        torch.max(torch.where(active, depth, 0)).to(torch.int32))

    # children compaction: ONE stable sort of the packed key moves the
    # split lanes to a dense prefix (grouped by fam, depth)
    skey = torch.where(split, meta, meta | ACCEPT_BIT)
    skey, order = torch.sort(skey, stable=True)
    sl, sr, sth = l[order], r[order], th[order]
    smid = (sl + sr) * 0.5
    ch_meta = (skey & ~ACCEPT_BIT) + 1
    n_split = int(syncs.pull(split.sum(dtype=torch.int32)))

    # push: left children [l, mid] at start, right children [mid, r] at
    # start + n_split (left window first; the right window's tail lands
    # only on dead slots)
    mid_start = start + n_split
    dyn_update(state.bag_l, sl, start)
    dyn_update(state.bag_l, smid, mid_start)
    dyn_update(state.bag_r, smid, start)
    dyn_update(state.bag_r, sr, mid_start)
    dyn_update(state.bag_th, sth, start)
    dyn_update(state.bag_th, sth, mid_start)
    dyn_update(state.bag_meta, ch_meta, start)
    dyn_update(state.bag_meta, ch_meta, mid_start)

    new_count_raw = start + 2 * n_split
    return dataclasses.replace(
        state, count=min(new_count_raw, capacity), acc=acc,
        tasks=state.tasks + n_take, splits=state.splits + n_split,
        iters=state.iters + 1, max_depth=max_depth,
        overflow=state.overflow or new_count_raw > capacity)


def run_bag(state: BagState, *, f_theta: Callable, eps: float, rule: Rule,
            chunk: int, capacity: int, max_iters: int, syncs: HostSyncs,
            stop_count: Optional[int] = None) -> BagState:
    """Run the bag to empty, or until it holds >= ``stop_count`` tasks
    (the walker's drain), or ``max_iters`` rounds."""
    while (state.count > 0 and not state.overflow
           and state.iters < max_iters
           and (stop_count is None or state.count < stop_count)):
        state = bag_step(state, f_theta, eps, rule, chunk, capacity, syncs)
    return state


def initial_bag(bounds, capacity: int, n_families: int, chunk: int,
                theta=None, *, device) -> BagState:
    """Seed the bag, on ``device``, with one [a, b] task per family. Dead
    slots hold an in-domain point of family 0 (masked lanes still
    evaluate them)."""
    bounds = np.asarray(bounds, dtype=np.float64).reshape(-1, 2)
    m = bounds.shape[0]
    if m > capacity:
        raise ValueError(f"{m} seed tasks exceed bag capacity {capacity}")
    if n_families > MAX_FAMILIES:
        raise ValueError(f"n_families={n_families} exceeds the meta-word "
                         f"fam field ({MAX_FAMILIES})")
    if theta is None:
        theta = np.zeros(m, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    dev = torch.device(device)
    fill = float(0.5 * (bounds[0, 0] + bounds[0, 1]))
    store = capacity + 2 * chunk
    f64 = torch.float64
    bag_l = torch.full((store,), fill, dtype=f64, device=dev)
    bag_l[:m] = torch.as_tensor(bounds[:, 0], dtype=f64, device=dev)
    bag_r = torch.full((store,), fill, dtype=f64, device=dev)
    bag_r[:m] = torch.as_tensor(bounds[:, 1], dtype=f64, device=dev)
    bag_th = torch.full((store,), float(theta[0]), dtype=f64, device=dev)
    bag_th[:m] = torch.as_tensor(theta, dtype=f64, device=dev)
    bag_meta = torch.zeros(store, dtype=torch.int32, device=dev)
    bag_meta[:m] = torch.arange(m, dtype=torch.int32,
                                device=dev) << DEPTH_BITS
    return BagState(
        bag_l=bag_l, bag_r=bag_r, bag_th=bag_th, bag_meta=bag_meta,
        count=m, acc=torch.zeros(n_families, dtype=f64, device=dev),
        max_depth=torch.zeros((), dtype=torch.int32, device=dev))


@dataclasses.dataclass
class FamilyResult:
    areas: np.ndarray           # (n_families,)
    metrics: RunMetrics
    lane_efficiency: float      # tasks / (iters * chunk)
    host_syncs: int = 0


def integrate_family(f_theta: Callable, theta: Sequence[float],
                     bounds, eps: float,
                     rule: Rule = Rule.TRAPEZOID,
                     chunk: int = 1 << 15,
                     capacity: int = 1 << 22,
                     max_iters: int = 1 << 20,
                     device="cuda") -> FamilyResult:
    """Integrate ``n`` independent problems ``f_theta(x, theta_i)`` over
    ``bounds`` (one (a, b) pair or an (n, 2) array) in float64."""
    dev = resolve_device(device)
    theta = np.asarray(theta, dtype=np.float64)
    m = theta.shape[0]
    bounds = np.asarray(bounds, dtype=np.float64)
    if bounds.ndim == 1:
        bounds = np.tile(bounds.reshape(1, 2), (m, 1))
    if chunk > capacity:
        raise ValueError(f"chunk={chunk} exceeds capacity={capacity}")
    syncs = HostSyncs()
    t0 = time.perf_counter()
    state = initial_bag(bounds, capacity, m, chunk, theta=theta, device=dev)
    out = run_bag(state, f_theta=f_theta, eps=float(eps), rule=Rule(rule),
                  chunk=int(chunk), capacity=int(capacity),
                  max_iters=int(max_iters), syncs=syncs)
    acc_np = np.asarray(syncs.pull(out.acc), dtype=np.float64)
    max_depth = int(syncs.pull(out.max_depth))
    wall = time.perf_counter() - t0
    if out.overflow:
        raise RuntimeError(
            f"bag overflowed capacity={capacity}; raise capacity")
    if out.count > 0:
        raise RuntimeError(f"max_iters={max_iters} exceeded with "
                           f"{out.count} tasks pending")
    if not np.all(np.isfinite(acc_np)):
        bad = int(np.sum(~np.isfinite(acc_np)))
        raise FloatingPointError(
            f"bag engine produced {bad}/{acc_np.size} non-finite areas "
            f"(NaN/inf); refusing to report them")
    metrics = RunMetrics(
        tasks=out.tasks, splits=out.splits,
        leaves=out.tasks - out.splits, rounds=out.iters,
        max_depth=max_depth,
        integrand_evals=out.tasks * EVALS_PER_TASK[Rule(rule)],
        wall_time_s=wall, n_chips=1, tasks_per_chip=[out.tasks])
    return FamilyResult(
        areas=acc_np, metrics=metrics,
        lane_efficiency=(out.tasks / (out.iters * chunk)
                         if out.iters else 0.0),
        host_syncs=syncs.n)
