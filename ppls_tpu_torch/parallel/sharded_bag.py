"""The family bag across devices: one chunked-LIFO bag per rank.

The counterpart of the reference's ``parallel/sharded_bag.py`` on
``torch.distributed`` (``mesh.py``):

* each rank owns a private bag (the farmer's bag, one per rank);
* every round each rank pops its own chunk and evaluates it in float64,
  and the round's children are dealt across the mesh: every rank's
  compacted children are gathered and rank d takes the global rows d,
  d + n, ... (``mesh.strided_reshard``), so a rank whose subdomain
  stopped refining receives children bred by busier ranks;
* per-family leaf areas accumulate in per-rank partials; the host adds
  them in rank order at the end, as the reference adds its chips';
* the loop ends when the sum of the ranks' bag counts is zero.

The reference runs the rounds in one ``lax.while_loop`` under
``shard_map``; each rank here runs a host loop (:func:`run_sharded_family`)
whose condition every rank computes from the same gathered counts, so
the ranks stay in lockstep. Split decisions are pointwise float64, so
the task totals are the single-device bag's and the per-rank histogram
is the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_family
from ppls_tpu_torch.ops.reduction import segment_sum_auto
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK, eval_batch
from ppls_tpu_torch.parallel.bag_engine import (
    ACCEPT_BIT, DEPTH_BITS, DEPTH_MASK, MAX_FAMILIES, BagState, FamilyResult,
    _clear_snapshot, dyn_slice, dyn_update)
from ppls_tpu_torch.parallel.mesh import (Mesh, dealt_counts, device_store,
                                          spmd_entry, strided_reshard)
from ppls_tpu_torch.runtime.checkpoint import (
    _family_identity, engine_name, load_family_checkpoint,
    save_family_checkpoint)
from ppls_tpu_torch.utils.metrics import RunMetrics

# The per-rank loop carry is the bag's own state (the reference's
# _ShardBag holds the same fields).
_ShardBag = BagState


def _shard_bag_round(mesh: Mesh, s: _ShardBag, f_theta, eps: float,
                     rule: Rule, chunk: int, capacity: int, m: int,
                     fill_l: float, fill_th: float):
    """One sharded bag round: the local pop and float64 evaluation, then
    the children dealt across the mesh and pushed on the local top.
    Returns ``(state, glob)``: the rank's new state, whose ``overflow``
    is replicated, and the new global bag count, both computed from the
    deal's gathered header on every rank."""
    n_take = min(s.count, chunk)
    start = s.count - n_take
    dev = s.bag_l.device
    l = dyn_slice(s.bag_l, start, chunk)
    r = dyn_slice(s.bag_r, start, chunk)
    th = dyn_slice(s.bag_th, start, chunk)
    meta = dyn_slice(s.bag_meta, start, chunk)
    active = torch.arange(chunk, dtype=torch.int32, device=dev) < n_take

    fam = meta >> DEPTH_BITS
    depth = meta & DEPTH_MASK
    value, _err, split = eval_batch(l, r, lambda x: f_theta(x, th), eps,
                                    rule)
    split = split & active
    accept = active & ~split
    acc = s.acc + segment_sum_auto(fam, torch.where(accept, value, 0.0), m,
                                   chunk)
    max_depth = torch.maximum(
        s.max_depth, torch.max(torch.where(active, depth, 0)).to(torch.int32))

    # children: the split rows in one stable sort of the packed key, then
    # the dense prefix [left children | right children]
    skey = torch.where(split, meta, meta | ACCEPT_BIT)
    skey, order = torch.sort(skey, stable=True)
    sl, sr, sth = l[order], r[order], th[order]
    smid = (sl + sr) * 0.5
    ch_meta = (skey & ~ACCEPT_BIT) + 1
    n_split = int(mesh.syncs.pull(split.sum(dtype=torch.int32)))
    k = n_split

    def pair(a, b):
        # (2 * chunk,) with the 2k valid rows first
        return torch.cat([a[:k], b[:k], a[k:], b[k:]])

    cols = (pair(sl, smid), pair(smid, sr), pair(sth, sth),
            pair(ch_meta, ch_meta))
    (tl, tr, tth, tm), _mine, total, header = strided_reshard(
        mesh, cols, 2 * n_split, (fill_l, fill_l, fill_th, 0), 2 * chunk,
        extra=(start,))
    n_mine = dealt_counts(total, mesh.size, 2 * chunk)
    for col, t in zip((s.bag_l, s.bag_r, s.bag_th, s.bag_meta),
                      (tl, tr, tth, tm)):
        dyn_update(col, t, start)
    # every rank's new count from the gathered (children, start) header:
    # the overflow flag and the loop's global count are replicated
    new_raw = header[:, 1] + n_mine
    any_ovf = bool(np.any(new_raw > capacity))
    glob = int(np.minimum(new_raw, capacity).sum())
    out = dataclasses.replace(
        s, count=int(min(new_raw[mesh.rank], capacity)), acc=acc,
        tasks=s.tasks + n_take, splits=s.splits + n_split,
        iters=s.iters + 1, max_depth=max_depth,
        overflow=s.overflow or any_ovf)
    return out, glob


def run_sharded_family(mesh: Mesh, s: _ShardBag, *, f_theta, eps: float,
                       rule: Rule, chunk: int, capacity: int, m: int,
                       max_iters: int, stop_iters: int, fill_l: float,
                       fill_th: float) -> _ShardBag:
    """The reference's ``build_sharded_family_run`` loop on one rank:
    rounds while the global count is positive, nothing overflowed and
    ``iters`` (the same on every rank) is below ``max_iters`` and the
    leg's ``stop_iters``."""
    glob = mesh.psum_host([s.count])[0]
    while (glob > 0 and not s.overflow and s.iters < max_iters
           and s.iters < stop_iters):
        s, glob = _shard_bag_round(mesh, s, f_theta, eps, rule, chunk,
                                   capacity, m, fill_l, fill_th)
    return s


def round_robin_seed_state(theta: np.ndarray, bounds: np.ndarray,
                           mesh: Mesh, store: int, capacity: int,
                           fill_l: float, fill_th: float):
    """This rank's seed columns: family j goes to rank j % n at the
    bottom of its bag. Returns ``(bag_l, bag_r, bag_th, bag_meta,
    count)``, the (store,) columns built on the rank's device."""
    n = mesh.size
    m = theta.shape[0]
    seeds_per = max(-(-m // n), 1)
    if seeds_per > capacity:
        raise ValueError(f"{m} seed tasks exceed per-chip "
                         f"capacity {capacity} on {n} chips")
    mine = np.arange(mesh.rank, m, n)
    k = mine.shape[0]
    blk_l = np.full(seeds_per, fill_l)
    blk_r = np.full(seeds_per, fill_l)
    blk_th = np.full(seeds_per, fill_th)
    blk_meta = np.zeros(seeds_per, dtype=np.int32)
    blk_l[:k] = bounds[mine, 0]
    blk_r[:k] = bounds[mine, 1]
    blk_th[:k] = theta[mine]
    blk_meta[:k] = mine << DEPTH_BITS
    dev = mesh.device
    return (device_store(store, fill_l, blk_l, device=dev),
            device_store(store, fill_l, blk_r, device=dev),
            device_store(store, fill_th, blk_th, device=dev),
            device_store(store, 0, blk_meta, torch.int32, dev), int(k))


def _sharded_bag_identity(family: str, eps: float, m: int,
                          theta: np.ndarray, bounds: np.ndarray,
                          n_dev: int, rule: Rule) -> dict:
    ident = _family_identity(engine_name("sharded-bag", rule), family,
                             eps, m, theta, bounds)
    ident["n_dev"] = n_dev       # per-rank state: the mesh size is identity
    return ident


def gather_prefix(mesh: Mesh, cols: Sequence[torch.Tensor], count: int,
                  store: int):
    """Every rank's live prefix for a snapshot: ``(counts, b, gathered)``
    with the (n,) live counts, the prefix width ``b`` (the next power of
    two above the largest count, at most ``store``) and the (n, b) host
    arrays of ``cols`` in their dtypes."""
    counts = mesh.gather_host([count])[:, 0]
    b = min(1 << int(max(int(counts.max()), 1)).bit_length(), store)
    packed = torch.stack([c[:b].to(torch.float64) for c in cols])
    g = mesh.syncs.pull_arrays(mesh.all_gather(packed))[0]   # (n, k, b)
    out = [g[:, j, :].astype(c[:0].cpu().numpy().dtype)
           for j, c in enumerate(cols)]
    return counts.astype(np.int32), b, out


def gather_rows(mesh: Mesh, t: torch.Tensor) -> np.ndarray:
    """``t`` of every rank as one host array, (n, *t.shape)."""
    return mesh.syncs.pull_arrays(mesh.all_gather(t))[0]


@spmd_entry
def integrate_family_sharded(
        family: str, theta: Sequence[float], bounds, eps: float,
        rule: Rule = Rule.TRAPEZOID,
        chunk: int = 1 << 12,
        capacity: int = 1 << 18,
        max_iters: int = 1 << 20,
        *, mesh: Mesh,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 256,
        _state_override=None,
        _totals_override: Optional[dict] = None,
        _crash_after_legs: Optional[int] = None) -> FamilyResult:
    """Integrate a parameterized family across the mesh (the module
    docstring). ``chunk`` and ``capacity`` are PER RANK; families are
    seeded round-robin; ``family`` is the registry name. ``n_devices``
    ranks run on ``device`` (CUDA by default; ``device="cpu"`` runs gloo
    ranks on the CPU); ``mesh.launch`` starts them unless the call is
    made inside a process group.

    With ``checkpoint_path`` the run goes in legs of ``checkpoint_every``
    rounds; each leg boundary gathers every rank's live bag prefix,
    accumulator and counters into one snapshot, written by rank 0 (the
    reference's container, the mesh size in its identity).
    :func:`resume_family_sharded` continues it bit-identically."""
    n_dev = mesh.size
    dev = mesh.device
    theta = np.asarray(theta, dtype=np.float64)
    m = theta.shape[0]
    if m > MAX_FAMILIES:
        raise ValueError(f"m={m} exceeds {MAX_FAMILIES}")
    bounds = np.asarray(bounds, dtype=np.float64)
    if bounds.ndim == 1:
        bounds = np.tile(bounds.reshape(1, 2), (m, 1))
    if chunk > capacity:
        raise ValueError(f"chunk={chunk} exceeds capacity={capacity}")
    f_theta = get_family(family)
    store = capacity + 2 * chunk
    fill_l = float(0.5 * (bounds[0, 0] + bounds[0, 1]))
    fill_th = float(theta[0])

    if _state_override is not None:
        bag_l, bag_r, bag_th, bag_meta, count0 = _state_override
    else:
        bag_l, bag_r, bag_th, bag_meta, count0 = round_robin_seed_state(
            theta, bounds, mesh, store, capacity, fill_l, fill_th)
    r = mesh.rank
    acc0 = np.zeros(m, dtype=np.float64)
    ctr = dict(tasks=0, splits=0, iters=0, maxd=0)
    if _totals_override is not None:
        acc0 = np.asarray(_totals_override["acc_per_chip"])[r]
        for k in ("tasks", "splits", "iters", "maxd"):
            ctr[k] = int(_totals_override["pc_" + k][r])

    t0 = time.perf_counter()
    s = _ShardBag(bag_l=bag_l, bag_r=bag_r, bag_th=bag_th, bag_meta=bag_meta,
                  count=int(count0),
                  acc=torch.tensor(acc0, dtype=torch.float64, device=dev),
                  tasks=ctr["tasks"], splits=ctr["splits"],
                  iters=ctr["iters"],
                  max_depth=torch.tensor(ctr["maxd"], dtype=torch.int32,
                                         device=dev))
    kw = dict(f_theta=f_theta, eps=float(eps), rule=Rule(rule),
              chunk=int(chunk), capacity=int(capacity), m=m,
              max_iters=int(max_iters), fill_l=fill_l, fill_th=fill_th)
    legs = 0
    while True:
        # iters advances in lockstep on every rank: the leg end agrees
        leg_end = (s.iters + int(checkpoint_every) if checkpoint_path
                   else int(max_iters))
        s = run_sharded_family(mesh, s, stop_iters=leg_end, **kw)
        left = mesh.psum_host([s.count])[0]
        finished = left == 0 or s.overflow
        if checkpoint_path is None or finished:
            break
        _snapshot_sharded(mesh, checkpoint_path, _sharded_bag_identity(
            family, float(eps), m, theta, bounds, n_dev, Rule(rule)), s,
            store)
        legs += 1
        if _crash_after_legs is not None and legs >= _crash_after_legs:
            raise RuntimeError(
                f"simulated crash after {legs} legs (test hook)")
        # snapshot before the max_iters exit: the non-convergence raise
        # leaves the final leg behind for a resume with a larger max_iters
        if s.iters >= max_iters:
            break
    wall = time.perf_counter() - t0

    if s.overflow:
        raise RuntimeError(
            f"sharded bag overflowed per-chip capacity={capacity}")
    if left > 0:
        raise RuntimeError(f"max_iters={max_iters} exceeded with "
                           f"{left} tasks pending")
    maxd = int(mesh.syncs.pull(s.max_depth))
    pc = mesh.gather_host([s.tasks, s.splits, s.iters, maxd])
    acc_h = gather_rows(mesh, s.acc)
    # the deterministic cross-rank reduction on the host, in rank order
    areas = np.sum(acc_h, axis=0)
    if not np.all(np.isfinite(areas)):
        bad = int(np.sum(~np.isfinite(areas)))
        raise FloatingPointError(
            f"sharded bag produced {bad}/{areas.size} non-finite areas")
    if mesh.rank == 0:
        _clear_snapshot(checkpoint_path)
    tasks_per_chip = [int(t) for t in pc[:, 0]]
    tasks = sum(tasks_per_chip)
    iters_sum = int(pc[:, 2].sum())
    metrics = RunMetrics(
        tasks=tasks, splits=int(pc[:, 1].sum()),
        leaves=tasks - int(pc[:, 1].sum()), rounds=int(pc[:, 2].max()),
        max_depth=int(pc[:, 3].max()),
        integrand_evals=tasks * EVALS_PER_TASK[Rule(rule)],
        wall_time_s=wall, n_chips=n_dev, tasks_per_chip=tasks_per_chip)
    return FamilyResult(
        areas=areas, metrics=metrics,
        lane_efficiency=tasks / (iters_sum * chunk) if iters_sum else 0.0,
        host_syncs=mesh.syncs.n, mesh=mesh.record())


def _snapshot_sharded(mesh: Mesh, path: str, identity: dict, s: _ShardBag,
                      store: int) -> None:
    """Gather every rank's live prefix, accumulator and counters; rank 0
    writes the snapshot."""
    counts, _b, (l, r, th, meta) = gather_prefix(
        mesh, (s.bag_l, s.bag_r, s.bag_th, s.bag_meta), s.count, store)
    maxd = int(mesh.syncs.pull(s.max_depth))
    pc = mesh.gather_host([s.tasks, s.splits, s.iters, maxd])
    acc = gather_rows(mesh, s.acc)
    if mesh.rank == 0:
        save_family_checkpoint(
            path, identity=identity,
            bag_cols={"l": l, "r": r, "th": th, "meta": meta,
                      "counts": counts},
            count=int(np.sum(counts)), acc=acc,
            totals={"pc_tasks": pc[:, 0].tolist(),
                    "pc_splits": pc[:, 1].tolist(),
                    "pc_iters": pc[:, 2].tolist(),
                    "pc_maxd": pc[:, 3].tolist(),
                    "acc_per_chip": acc.tolist()})
    mesh.barrier()


@spmd_entry
def resume_family_sharded(
        path: str, family: str, theta: Sequence[float], bounds,
        eps: float,
        rule: Rule = Rule.TRAPEZOID,
        chunk: int = 1 << 12,
        capacity: int = 1 << 18,
        max_iters: int = 1 << 20,
        *, mesh: Mesh,
        checkpoint_every: int = 256) -> FamilyResult:
    """Continue an interrupted :func:`integrate_family_sharded` run from
    its last leg snapshot (identity-checked, the mesh size and the rule
    included), bit-identical to the uninterrupted run: every rank's
    exact state re-enters its device unchanged."""
    n_dev = mesh.size
    theta_np = np.asarray(theta, dtype=np.float64)
    m = theta_np.shape[0]
    bounds_np = np.asarray(bounds, dtype=np.float64)
    if bounds_np.ndim == 1:
        bounds_np = np.tile(bounds_np.reshape(1, 2), (m, 1))
    identity = _sharded_bag_identity(family, float(eps), m, theta_np,
                                     bounds_np, n_dev, Rule(rule))
    bag_cols, _count, acc, totals = load_family_checkpoint(path, identity)
    store = capacity + 2 * chunk
    counts = np.asarray(bag_cols["counts"], dtype=np.int32)
    b = bag_cols["l"].shape[1]
    if b > store or int(counts.max(initial=0)) > store:
        raise ValueError(
            f"resume sizing mismatch: snapshot prefix width {b} does "
            f"not fit the store {store} from this call's chunk/capacity;"
            f" resume with the original run's sizing parameters")
    fill_l = float(0.5 * (bounds_np[0, 0] + bounds_np[0, 1]))
    fill_th = float(theta_np[0])
    r, dev = mesh.rank, mesh.device
    state = (device_store(store, fill_l, bag_cols["l"][r], device=dev),
             device_store(store, fill_l, bag_cols["r"][r], device=dev),
             device_store(store, fill_th, bag_cols["th"][r], device=dev),
             device_store(store, 0, bag_cols["meta"][r], torch.int32, dev),
             int(counts[r]))
    totals = dict(totals)
    # the binary-exact npz accumulator, not the JSON round trip
    totals["acc_per_chip"] = np.asarray(acc)
    return integrate_family_sharded(
        family, theta, bounds, eps, rule=rule, chunk=chunk,
        capacity=capacity, max_iters=max_iters, mesh=mesh,
        checkpoint_path=path, checkpoint_every=checkpoint_every,
        _state_override=state, _totals_override=totals)
