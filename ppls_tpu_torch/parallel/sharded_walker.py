"""The demand-driven walker across devices: the flagship engine on a mesh.

The counterpart of the reference's ``parallel/sharded_walker.py`` on
``torch.distributed`` (``mesh.py``): every rank runs the single-device
walker's breed, sort, walk, expand and drain (``walker.py``) on its own
share of a globally rebalanced root queue, through K1 or K2 on its own
device. Each cycle:

* BREED: in legacy mode (``refill_slots`` = 0) it is collective: sharded
  bag rounds (``sharded_bag._shard_bag_round``: local pop and eval, the
  children dealt across the mesh every round) until the global root
  count reaches ``n * target_local`` or passes its peak, so the bred
  queue is balanced to within one row per rank. In refill mode (R > 0)
  the breed is rank-local (``walker._breed``, no collective) unless the
  global queue is below the bank-dry floor ``n * min_active``, when the
  collective breed refines and re-spreads the few surviving tips;
* SORT and WALK are local: the work sort of the rank's queue top, then
  K1 (``walker._run_walk_kernel_refill``, R > 0) or K2
  (``walker._run_walk``, R = 0) on the rank's device, no collective;
* EXPAND is local (``walker._expand_pending``);
* REBALANCE (refill mode only): ONE ``mesh.phase_reshard`` per walk
  phase deals every rank's top ``reshard_window`` rows round-robin,
  stratified by depth, when the global remainder reaches the rebalance
  floor;
* DRAIN is local behind a per-rank gate (``run_bag`` or the theta bag);
* the loop ends when the sum of the local counts is zero.

``collective_rounds`` counts one per collective breed round and one per
taken phase reshard; every rank counts the same. The refill mode's
acceptance number is ``collective_rounds / cycles`` strictly below the
legacy mode's on the same workload.

The reference runs a leg as one jitted ``shard_map`` program with
``psum``-replicated loop conditions. Each rank here runs a host loop
whose every condition it computes from a collective that all ranks
reach in the same order: the cycle condition from one sum of (count,
overflow) per cycle, each breed round's from the deal's gathered
header, the reshard decision from its window-count gather. The
per-rank partial areas are gathered and added on the host in rank
order, as the reference adds its chips' (``np.sum(acc, axis=0)``).

With ``checkpoint_path`` the run goes in legs of ``checkpoint_every``
cycles; at each leg boundary every rank's live bag prefix, partial
areas and counters are gathered and rank 0 writes one snapshot in the
reference's container. :func:`resume_family_walker_dd` continues it
bit-identically, or, with ``mesh_resize``, re-deals it onto another
world size (``mesh.host_strided_redeal``).

With ``admit_window`` = AW > 0, :func:`build_dd_walker_run` is the
walker-dd stream's phase body (``runtime/stream.py``): one cycle per call,
with the rank's admitted seed block pushed onto its queue top and the
recycled slots' partial areas cleared as the phase opens, and each
rank's family live counts returned for retirement. :class:`DDStreamRank`
is one rank's state of that stream inside a persistent
``mesh.World``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import (check_ds_domain, get_family,
                                              get_family_ds)
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK
from ppls_tpu_torch.parallel import walker as W
from ppls_tpu_torch.parallel.bag_engine import (DEPTH_MASK, BagState,
                                                _clear_snapshot, dyn_update,
                                                run_bag)
from ppls_tpu_torch.parallel.mesh import (Mesh, dealt_counts, device_store,
                                          host_strided_redeal, phase_reshard,
                                          spmd_entry)
from ppls_tpu_torch.parallel.sharded_bag import (_shard_bag_round,
                                                 gather_prefix, gather_rows,
                                                 round_robin_seed_state)
from ppls_tpu_torch.runtime.checkpoint import (
    _family_identity, engine_name, load_family_checkpoint,
    save_family_checkpoint)
from ppls_tpu_torch.runtime.tune import workload_signature
from ppls_tpu_torch.utils.metrics import RunMetrics

# the 11 per-rank cycle counters, in carry and snapshot order. Most are
# mesh totals (summed over ranks when reported); "rounds" reports as the
# per-rank maximum and "crounds" is the same on every rank.
CTR64 = ("tasks", "splits", "btasks", "wtasks", "wsplits", "roots",
         "rounds", "segs", "wsteps", "srows", "crounds")
_CTR64_MAX = ("rounds", "crounds")


@dataclasses.dataclass
class _DDCarry:
    """One rank's cycle-loop carry."""

    bag_l: torch.Tensor       # (store,) local bag columns
    bag_r: torch.Tensor
    bag_th: torch.Tensor
    bag_meta: torch.Tensor
    count: int                # local live-entry count
    acc: torch.Tensor         # (m_eff,) float64 per-rank partial areas
    ctr: dict                 # CTR64 -> int
    waste: np.ndarray         # (N_WASTE,) lane-waste buckets
    evals: np.ndarray         # (2,) scout / confirm kernel evals
    maxd: int
    overflow: bool            # the same on every rank


def _local_bag(c: _DDCarry, m: int) -> BagState:
    """The rank's bag as a fresh ``BagState`` (zero accumulator and
    counters) on the carry's store."""
    dev = c.bag_l.device
    return BagState(
        bag_l=c.bag_l, bag_r=c.bag_r, bag_th=c.bag_th, bag_meta=c.bag_meta,
        count=c.count,
        acc=torch.zeros(m, dtype=torch.float64, device=dev),
        max_depth=torch.zeros((), dtype=torch.int32, device=dev))


def build_dd_walker_run(mesh: Mesh, family: str, eps: float,
                        breed_chunk: int, capacity: int, m: int, lanes: int,
                        seg_iters: int, max_segments: int,
                        min_active_frac: float, exit_frac: float,
                        suspend_frac: float, target_local: int,
                        max_cycles: int, fill_l: float, fill_th: float,
                        rule: Rule = Rule.TRAPEZOID,
                        sort_roots: bool = True,
                        sort_skip_ratio: float = W.SORT_SKIP_RATIO,
                        refill_slots: int = 0, reshard_window: int = 0,
                        admit_window: int = 0, scout: bool = False,
                        double_buffer: bool = False, reduced: bool = False,
                        theta_block: int = 1, theta_table=None):
    """The demand-driven leg on one rank: returns ``run(c) -> (c,
    cycles, left)``, which runs up to ``max_cycles`` cycles (the module
    docstring) from the carry ``c`` and returns the new carry, the cycles
    run and the global count left. ``theta_table`` is the (m, T) float64
    theta table on the rank's device when ``theta_block`` > 1; ``run``'s
    own ``theta_table`` replaces it from that call on.

    With ``admit_window`` = AW > 0 it is the streaming phase body:
    ``run(c, admit)`` with ``admit = (l, r, th, meta, n_adm, clear)``,
    this rank's (AW,) admitted-seed block (a dense prefix of ``n_adm``
    rows, in-domain fill past it) and the (m,) recycled-slot mask, first
    clears the recycled slots' partial areas, pushes the block onto the
    rank's queue top and folds the capacity predicate into the cycle's
    overflow sum, then runs the cycle; it returns ``(c, cycles, left,
    fam_live)`` with this rank's (m,) int32 live rows per family. The
    stream requires ``max_cycles == 1`` and ``refill_slots`` > 0."""
    if admit_window:
        if max_cycles != 1:
            raise ValueError("admit_window requires max_cycles == 1 "
                             "(one cycle per admission boundary)")
        if not refill_slots:
            raise ValueError("admit_window requires refill_slots > 0 "
                             "(admission rides the refill mode's "
                             "phase-granular reshard)")
    f_theta = get_family(family)
    f_ds = get_family_ds(family, reduced=reduced)
    syncs = mesh.syncs
    n_dev = mesh.size
    T = int(theta_block)
    m_eff = m * T
    rule = Rule(rule)
    # split-only breeding in theta mode, the target clamped to one deal
    breed_eps = -1.0 if T > 1 else eps
    if T > 1:
        target_local = W.theta_breed_target(target_local, refill_slots,
                                            lanes, T)
    target_global = n_dev * target_local
    min_active = max(1, int(lanes * min_active_frac))
    if not reshard_window:
        reshard_window = 2 * breed_chunk
    rebalance_floor = max(n_dev, min_active)
    bank_dry_floor = n_dev * min_active
    tt = {"v": theta_table}      # the theta table the next cycle reads
    wkw = dict(f_ds=f_ds, eps=eps, m=m, seg_iters=seg_iters,
               max_segments=max_segments, min_active_frac=min_active_frac,
               exit_frac=exit_frac, suspend_frac=suspend_frac, lanes=lanes,
               gsegs0=0, rule=rule, scout=scout, syncs=syncs)

    def breed_collective(c: _DDCarry, glob: int):
        """Sharded bag rounds, the same number on every rank (each round's
        condition comes from the previous round's gathered header)."""
        dev = c.bag_l.device
        s = BagState(bag_l=c.bag_l, bag_r=c.bag_r, bag_th=c.bag_th,
                     bag_meta=c.bag_meta, count=c.count, acc=c.acc,
                     tasks=c.ctr["tasks"], splits=c.ctr["splits"],
                     max_depth=torch.tensor(c.maxd, dtype=torch.int32,
                                            device=dev),
                     overflow=c.overflow)
        prev = 0
        while (glob > 0 and not s.overflow and s.iters < (1 << 20)
               and glob < target_global and glob >= prev):
            prev = glob
            s, glob = _shard_bag_round(mesh, s, f_theta, breed_eps, rule,
                                       breed_chunk, capacity, m_eff, fill_l,
                                       fill_th)
        ctr = dict(c.ctr, tasks=s.tasks, splits=s.splits,
                   btasks=c.ctr["btasks"] + s.tasks - c.ctr["tasks"],
                   rounds=c.ctr["rounds"] + s.iters,
                   crounds=c.ctr["crounds"] + s.iters)
        return (dataclasses.replace(c, count=s.count, acc=s.acc, ctr=ctr,
                                    overflow=s.overflow), s.max_depth)

    def breed_local(c: _DDCarry):
        """The rank-local breed (refill mode): the single-device float64
        BFS with no collective; its overflow joins the cycle's sum."""
        bred = W._breed(_local_bag(c, m_eff), f_theta=f_theta, eps=breed_eps,
                        chunk=breed_chunk, capacity=capacity,
                        target=target_local, rule=rule, syncs=syncs)
        ctr = dict(c.ctr, tasks=c.ctr["tasks"] + bred.tasks,
                   splits=c.ctr["splits"] + bred.splits,
                   btasks=c.ctr["btasks"] + bred.tasks,
                   rounds=c.ctr["rounds"] + bred.iters)
        return (dataclasses.replace(c, count=bred.count, acc=c.acc + bred.acc,
                                    ctr=ctr, overflow=bred.overflow),
                bred.max_depth)

    def rebalance(bag2: BagState) -> tuple:
        """ONE phase reshard: the replicated decision, the dealt window
        written back at the window's start, the replicated overflow."""
        (tl, tr, tth, tm), n_mine, did, header = phase_reshard(
            mesh, (bag2.bag_l, bag2.bag_r, bag2.bag_th, bag2.bag_meta),
            bag2.count, (fill_l, fill_l, fill_th, 0), reshard_window,
            rebalance_floor, sort_key=bag2.bag_meta & DEPTH_MASK,
            extra=(bag2.count,))
        if not did:
            return bag2, 0
        start = bag2.count - int(header[mesh.rank, 0])
        for col, t in zip((bag2.bag_l, bag2.bag_r, bag2.bag_th,
                           bag2.bag_meta), (tl, tr, tth, tm)):
            dyn_update(col, t, start)
        # every rank's new count from the gathered (window, count) rows
        new = (header[:, 1] - header[:, 0]
               + dealt_counts(int(header[:, 0].sum()), n_dev,
                              reshard_window))
        return dataclasses.replace(
            bag2, count=min(start + n_mine, capacity),
            overflow=bag2.overflow or bool(np.any(new > capacity))), 1

    def drain(b: BagState) -> BagState:
        dkw = dict(f_theta=f_theta, eps=eps, capacity=capacity,
                   max_iters=1 << 20, syncs=syncs, stop_count=target_local)
        if T > 1:
            return W._run_theta_bag(
                b, theta_table=tt["v"], theta_block=T,
                chunk=W.theta_drain_chunk(breed_chunk, T), **dkw)
        return run_bag(b, rule=rule, chunk=breed_chunk, **dkw)

    def cycle(c: _DDCarry, glob: int):
        if refill_slots and glob >= bank_dry_floor:
            bred, bmaxd = breed_local(c)
        else:
            bred, bmaxd = breed_collective(c, glob)
        local = _local_bag(bred, m_eff)
        srows = 0
        if sort_roots:
            local, srows = W._order_roots_by_work(
                local, f_theta=f_theta, eps=eps, rule=rule,
                window=2 * breed_chunk, skip_ratio=sort_skip_ratio,
                syncs=syncs)
        stats = np.zeros((W.S_CAP, len(W.SEG_STAT_FIELDS)), dtype=np.int64)
        if refill_slots:
            walk = W._run_walk_kernel_refill(
                local, refill_slots=refill_slots, double_buffer=double_buffer,
                theta_block=T, theta_table=tt["v"], seg_stats0=stats,
                **wkw)
        else:
            walk = W._run_walk(local, seg_stats0=stats, **wkw)
        bag2 = W._expand_pending(walk, local, capacity, m_eff, syncs, T)
        d_crounds = 0
        if refill_slots:
            bag2, d_crounds = rebalance(bag2)
        bag3 = drain(bag2) if bag2.count < min_active else bag2
        s = walk.lanes
        wt, ws, wmaxd, bmd, dmd = syncs.pull(torch.stack([
            s.tasks.sum(dtype=torch.int64), s.splits.sum(dtype=torch.int64),
            s.maxd.max().to(torch.int64), bmaxd.to(torch.int64),
            bag3.max_depth.to(torch.int64)]))
        k = bred.ctr
        ctr = dict(
            tasks=k["tasks"] + wt + bag3.tasks,
            splits=k["splits"] + ws + bag3.splits,
            btasks=k["btasks"] + bag3.tasks, wtasks=k["wtasks"] + wt,
            wsplits=k["wsplits"] + ws, roots=k["roots"] + walk.taken,
            rounds=k["rounds"] + bag3.iters, segs=k["segs"] + walk.segs,
            wsteps=k["wsteps"] + walk.steps, srows=k["srows"] + srows,
            crounds=k["crounds"] + d_crounds)
        out = _DDCarry(
            bag_l=bag3.bag_l, bag_r=bag3.bag_r, bag_th=bag3.bag_th,
            bag_meta=bag3.bag_meta, count=bag3.count,
            acc=bred.acc + walk.acc + bag3.acc, ctr=ctr,
            waste=c.waste + walk.waste, evals=c.evals + walk.evals,
            maxd=max(c.maxd, bmd, dmd, wmaxd),
            overflow=c.overflow)
        return out, bred.overflow or bag3.overflow

    def admit_local(c: _DDCarry, adm_l, adm_r, adm_th, adm_meta, n_adm,
                    clear) -> _DDCarry:
        """Streaming admission at the phase open: clear the recycled
        slots' partial areas, push the block onto the queue top (the
        store's slack covers the window: ``_dd_sizing``), and raise the
        local capacity predicate, which the cycle's first sum
        replicates. The cleared accumulator is the one carried on (the
        reference's round-14 repair: a recycled slot must not keep its
        previous request's partial)."""
        dev = c.acc.device
        clear = torch.as_tensor(np.asarray(clear), dtype=torch.bool,
                                device=dev)
        if T > 1:
            clear = clear.repeat_interleave(T)
        acc2 = torch.where(clear, torch.zeros((), dtype=c.acc.dtype,
                                              device=dev), c.acc)
        start, width = c.count, int(np.asarray(adm_l).shape[0])
        store = c.bag_l.shape[0]
        if start + width > store:
            raise ValueError(
                f"admit window of {width} rows at count {start} overruns "
                f"the rank's store ({store} rows)")
        for col, blk in ((c.bag_l, adm_l), (c.bag_r, adm_r),
                         (c.bag_th, adm_th), (c.bag_meta, adm_meta)):
            col[start:start + width] = torch.as_tensor(
                np.asarray(blk), dtype=col.dtype).to(dev)
        cnt = start + int(n_adm)
        return dataclasses.replace(c, count=cnt, acc=acc2,
                                   overflow=c.overflow or cnt > capacity)

    def run(c: _DDCarry, admit=None, theta_table=None):
        if theta_table is not None:
            tt["v"] = theta_table
        if admit_window:
            c = admit_local(c, *admit)
        glob, n_ovf = mesh.psum_host([c.count, int(c.overflow)])
        c.overflow = c.overflow or n_ovf > 0
        cycles = 0
        while glob > 0 and cycles < max_cycles and not c.overflow:
            c, local_ovf = cycle(c, glob)
            # the cycle condition and the overflow, replicated: one sum
            glob, n_ovf = mesh.psum_host([c.count, int(local_ovf)])
            c.overflow = c.overflow or n_ovf > 0
            cycles += 1
        if admit_window:
            return c, cycles, glob, W.family_live_counts_cols(
                c.bag_meta, c.count, m)
        return c, cycles, glob

    return run


def _dd_sizing(lanes: int, capacity: int, chunk: int, roots_per_lane: int,
               theta_block: int = 1):
    """``(target_local, breed_chunk, store, reshard_window)``: one sizing
    for integrate and resume. The collective breed pops each rank's whole
    share every round (chunk >= the per-rank target); the slack past
    capacity covers the push windows, the expand grid with its untaken
    dealt roots, and the phase reshard's window, which equals it."""
    target_local = min(roots_per_lane * (lanes // int(theta_block)),
                       capacity // 2)
    breed_chunk = max(1 << int(max(target_local, 1) - 1).bit_length(),
                      chunk)
    slack = max(2 * breed_chunk,
                (W.MAX_REL_DEPTH + 1 + roots_per_lane) * lanes)
    return target_local, breed_chunk, capacity + slack, slack


def _seed_state(bounds: np.ndarray, theta: np.ndarray, mesh: Mesh,
                store: int, capacity: int, fill_l: float, fill_th: float):
    """Round-robin family seeds, the sharded bag's scheme
    (``sharded_bag.round_robin_seed_state``)."""
    return round_robin_seed_state(theta, bounds, mesh, store, capacity,
                                  fill_l, fill_th)


def _launch_counts() -> tuple:
    return W.run_segment_rf.launches, W.run_segment_ee.launches


@spmd_entry
def integrate_family_walker_dd(
        family: str, theta: Sequence[float], bounds, eps: float,
        chunk: int = 1 << 12,
        capacity: int = 1 << 20,
        lanes: int = 1 << 12,
        roots_per_lane: int = 12,
        seg_iters: int = 2048,
        max_segments: int = 1 << 18,
        min_active_frac: float = 0.1,
        exit_frac: Optional[float] = None,
        suspend_frac: Optional[float] = None,
        max_cycles: int = 64,
        rule: Rule = Rule.TRAPEZOID,
        sort_roots: bool = True,
        sort_skip_ratio: float = W.SORT_SKIP_RATIO,
        refill_slots: int = 0,
        scout_dtype: Optional[str] = None,
        double_buffer: bool = False,
        reduced_integrands: bool = False,
        theta_block: int = 1,
        nan_policy: str = "raise",
        *, mesh: Mesh,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
        _state_override=None,
        _totals_override: Optional[dict] = None,
        _crash_after_legs: Optional[int] = None) -> W.WalkerResult:
    """The demand-driven flagship walker across the mesh (the module
    docstring), with the reference's parameters. ``family`` is the
    registry name (the float64 integrand and its ds twin come from it);
    ``chunk``, ``capacity`` and ``lanes`` are PER RANK. ``refill_slots``
    R > 0 walks each rank through K1 with one phase reshard per walk
    phase; 0 walks through K2 behind collective breed rounds.

    ``n_devices`` ranks run on ``device``: CUDA by default (rank r on
    ``cuda:(r % device_count)``, NCCL when each rank owns a card, gloo
    staged through host memory when ranks share one), or
    ``device="cpu"`` (gloo ranks, the plain segments). Inside a process
    group the call is the rank's SPMD body; outside one it starts the
    ranks and returns rank 0's result. Cadence resolves through the
    tuning table with ``mesh_shape`` = the world size. The result's
    ``mesh`` holds the transport, rank 0's collective calls by kind, and
    every rank's host syncs and K1 / K2 launches."""
    if lanes % 128:
        raise ValueError(f"lanes must be a multiple of 128, got {lanes}")
    if refill_slots < 0 or refill_slots > roots_per_lane:
        raise ValueError(
            f"refill_slots must be in [0, roots_per_lane={roots_per_lane}]"
            f", got {refill_slots}")
    scout = W.resolve_scout_dtype(scout_dtype, rule)
    W.validate_double_buffer(double_buffer, refill_slots)
    n_dev, r, dev = mesh.size, mesh.rank, mesh.device
    exit_frac, suspend_frac = W.resolve_cadence(
        exit_frac, suspend_frac, scout, refill_slots,
        signature=workload_signature(
            family, eps, rule, theta_block=int(theta_block),
            mesh_shape=int(n_dev), scout=scout,
            refill_slots=int(refill_slots)), device=dev)
    theta2d, rep_theta = W.normalize_theta_batch(theta, theta_block)
    m = theta2d.shape[0]
    T = W.validate_theta_block(theta_block, lanes=lanes,
                               refill_slots=refill_slots, rule=rule, m=m)
    m_eff = m * T
    bounds = np.asarray(bounds, dtype=np.float64)
    if bounds.ndim == 1:
        bounds = np.tile(bounds.reshape(1, 2), (m, 1))
    check_ds_domain(get_family_ds(family, reduced=reduced_integrands),
                    np.repeat(bounds, T, axis=0), theta2d.reshape(-1))
    target_local, breed_chunk, store, reshard_window = _dd_sizing(
        lanes, capacity, chunk, roots_per_lane, T)
    fill_l = float(0.5 * (bounds[0, 0] + bounds[0, 1]))
    fill_th = float(rep_theta[0])
    run = build_dd_walker_run(
        mesh, family, float(eps), int(breed_chunk), int(capacity), int(m),
        int(lanes), int(seg_iters), int(max_segments),
        float(min_active_frac), float(exit_frac), float(suspend_frac),
        int(target_local),
        int(checkpoint_every if checkpoint_path else max_cycles),
        fill_l, fill_th, Rule(rule), bool(sort_roots),
        float(sort_skip_ratio), int(refill_slots), int(reshard_window),
        scout=bool(scout), double_buffer=bool(double_buffer),
        reduced=bool(reduced_integrands), theta_block=T,
        theta_table=(torch.tensor(theta2d, dtype=torch.float64, device=dev)
                     if T > 1 else None))

    if _state_override is not None:
        bag_l, bag_r, bag_th, bag_meta, count0 = _state_override
    else:
        bag_l, bag_r, bag_th, bag_meta, count0 = _seed_state(
            bounds, rep_theta, mesh, store, capacity, fill_l, fill_th)
    c = _DDCarry(bag_l=bag_l, bag_r=bag_r, bag_th=bag_th, bag_meta=bag_meta,
                 count=int(count0),
                 acc=torch.zeros(m_eff, dtype=torch.float64, device=dev),
                 ctr=dict.fromkeys(CTR64, 0),
                 waste=np.zeros(W.N_WASTE, dtype=np.int64),
                 evals=np.zeros(2, dtype=np.int64), maxd=0, overflow=False)
    cycles_done = est_kevals = 0
    if _totals_override is not None:
        t = _totals_override
        c.acc = torch.tensor(np.asarray(t["acc_per_chip"])[r],
                             dtype=torch.float64, device=dev)
        for k in CTR64:
            # snapshots from before the sort accounting lack pc_srows
            c.ctr[k] = int(t.get("pc_" + k, [0] * n_dev)[r])
        c.maxd = int(t["pc_maxd"][r])
        w_in = np.asarray(t.get("waste", np.zeros((n_dev, W.N_WASTE))),
                          dtype=np.int64).reshape(n_dev, -1)[r]
        # snapshots from before the theta bucket carry 4 buckets
        c.waste[:w_in.shape[0]] = w_in
        c.evals = np.asarray(t.get("evals", np.zeros((n_dev, 2))),
                             dtype=np.int64).reshape(n_dev, 2)[r].copy()
        est_kevals = int(t.get("est_kevals", 0))
        cycles_done = int(t["cycles"])
    identity = (None if checkpoint_path is None else _dd_ckpt_identity(
        family, float(eps), m, theta2d, bounds, n_dev, Rule(rule),
        int(refill_slots), scout=scout, double_buffer=double_buffer,
        reduced=reduced_integrands, theta_block=T))

    k1_0, k2_0 = _launch_counts()
    t0 = time.perf_counter()
    legs = 0
    while True:
        c, cycles, left = run(c)
        cycles_done += cycles
        if checkpoint_path is None or c.overflow or left == 0:
            break
        # leg boundary: the snapshot comes before the max_cycles exit, so
        # "raise max_cycles and resume" continues from the latest cycle
        _snapshot_dd(mesh, checkpoint_path, identity, c, store, cycles_done,
                     est_kevals)
        legs += 1
        if _crash_after_legs is not None and legs >= _crash_after_legs:
            raise RuntimeError(
                f"simulated crash after {legs} legs (test hook)")
        if cycles_done >= max_cycles:
            break
    k1_1, k2_1 = _launch_counts()
    pc = mesh.gather_host([*(c.ctr[k] for k in CTR64), c.maxd, *c.waste,
                           *c.evals, k1_1 - k1_0, k2_1 - k2_0, mesh.syncs.n])
    acc_h = gather_rows(mesh, c.acc)
    wall = time.perf_counter() - t0

    per = {k: pc[:, j] for j, k in enumerate(CTR64)}
    j = len(CTR64)
    maxd_pc = pc[:, j]
    waste_pc = pc[:, j + 1:j + 1 + W.N_WASTE]
    j += 1 + W.N_WASTE
    evals_pc = pc[:, j:j + 2]
    tot = {k: int(np.sum(per[k])) for k in CTR64}
    tot["rounds"] = int(np.max(per["rounds"]))
    # crounds is the same on every rank: the mesh total is its value
    tot["crounds"] = int(np.max(per["crounds"]))
    if c.overflow:
        raise RuntimeError(
            "dd walker bag overflowed; raise capacity (on theta_block "
            "runs this also fires when a walk phase's step budget "
            "expired mid-root — raise max_segments/seg_iters)")
    if left > 0:
        raise RuntimeError(
            f"dd walker did not converge in {cycles_done} cycles "
            f"({left} tasks left); raise max_cycles")
    areas = np.sum(acc_h, axis=0)      # fixed rank order: deterministic
    if T > 1:
        areas = areas.reshape(m, T)
    failed = W.quarantine_failed_mask(areas, nan_policy, "walker-dd")
    if r == 0:
        _clear_snapshot(checkpoint_path)

    tasks_per_chip = [int(t) for t in per["tasks"]]
    tasks, wtasks = tot["tasks"], tot["wtasks"]
    waste_tot = waste_pc.sum(axis=0)
    evals_tot = evals_pc.sum(axis=0)
    sevals, cevals = int(evals_tot[0]), int(evals_tot[1])
    kernel_evals, evals_estimated = W.derive_kernel_evals(
        sevals, cevals, int(waste_tot[0]), wtasks, tot["wsplits"],
        tot["roots"], rule, est_kevals=est_kevals)
    ept = EVALS_PER_TASK[Rule(rule)]     # float64 evals per bag task
    metrics = RunMetrics(
        tasks=tasks, splits=tot["splits"], leaves=tasks - tot["splits"],
        rounds=tot["rounds"] + tot["segs"],
        max_depth=int(np.max(maxd_pc)),
        integrand_evals=ept * tot["btasks"] + kernel_evals
        + ept * tot["srows"],
        wall_time_s=wall, n_chips=n_dev, tasks_per_chip=tasks_per_chip)
    denom = tot["wsteps"] * lanes
    rec = mesh.record()
    rec.update(launches={"run_segment_rf": pc[:, -3].tolist(),
                         "run_segment_ee": pc[:, -2].tolist()},
               host_syncs=pc[:, -1].tolist())
    return W.WalkerResult(
        areas=areas, metrics=metrics,
        lane_efficiency=wtasks / denom if denom else 0.0,
        walker_fraction=wtasks / tasks if tasks else 0.0,
        cycles=cycles_done, lanes=int(lanes), kernel_steps=tot["wsteps"],
        refill_slots=int(refill_slots), collective_rounds=tot["crounds"],
        waste=waste_tot, waste_per_chip=waste_pc, scout_evals=sevals,
        confirm_evals=cevals if sevals else int(waste_tot[0]),
        evals_estimated=evals_estimated,
        host_syncs=int(pc[:, -1].sum()),
        device=str(dev), failed=failed, mesh=rec)


def _snapshot_dd(mesh: Mesh, path: str, identity: dict, c: _DDCarry,
                 store: int, cycles_done: int, est_kevals: int) -> None:
    """Gather every rank's live prefix, partial areas and counters; rank
    0 writes the snapshot (the reference's keys)."""
    counts, _b, (l, r, th, meta) = gather_prefix(
        mesh, (c.bag_l, c.bag_r, c.bag_th, c.bag_meta), c.count, store)
    pc = mesh.gather_host([*(c.ctr[k] for k in CTR64), c.maxd, *c.waste,
                           *c.evals])
    acc = gather_rows(mesh, c.acc)
    if mesh.rank == 0:
        _write_dd(path, identity, (l, r, th, meta), counts, pc, acc,
                  cycles_done, est_kevals)
    mesh.barrier()


def _write_dd(path, identity, cols, counts, pc, acc, cycles_done,
              est_kevals) -> None:
    """Rank 0's snapshot write, the reference's keys."""
    l, r, th, meta = cols
    j = len(CTR64)
    totals = {"pc_" + k: pc[:, i].tolist() for i, k in enumerate(CTR64)}
    totals["pc_maxd"] = pc[:, j].tolist()
    totals["waste"] = pc[:, j + 1:j + 1 + W.N_WASTE].tolist()
    totals["evals"] = pc[:, j + 1 + W.N_WASTE:].tolist()
    totals["est_kevals"] = est_kevals
    totals["cycles"] = cycles_done
    totals["acc_per_chip"] = acc.tolist()
    save_family_checkpoint(
        path, identity=identity,
        bag_cols={"l": l, "r": r, "th": th, "meta": meta, "counts": counts},
        count=int(np.sum(counts)), acc=acc, totals=totals)


def _dd_ckpt_identity(family: str, eps: float, m: int, theta: np.ndarray,
                      bounds: np.ndarray, n_dev: int,
                      rule: Rule = Rule.TRAPEZOID, refill_slots: int = 0,
                      scout: bool = False, double_buffer: bool = False,
                      reduced: bool = False, theta_block: int = 1) -> dict:
    """The reference's dd identity: the problem, the mesh size, and the
    schedule modes as conditional keys (the refill mode, scouting, the
    double buffer, the reduced twin, theta_block > 1)."""
    ident = _family_identity(engine_name("walker-dd", rule), family, eps,
                             m, theta, bounds)
    ident["n_dev"] = n_dev       # per-rank state: the mesh size is identity
    if refill_slots:
        ident["refill_slots"] = int(refill_slots)
    if scout:
        ident["scout"] = True
    if double_buffer:
        ident["double_buffer"] = True
    if reduced:
        ident["reduced"] = True
    if int(theta_block) > 1:
        ident["theta_block"] = int(theta_block)
    return ident


def _resize_dd_totals(totals: dict, acc: np.ndarray, n_old: int,
                      n_new: int) -> dict:
    """A dd snapshot's per-rank totals on an n_new-rank mesh (elastic
    resume): summed counters, waste buckets, evals and partial areas land
    as their column sums on rank 0 (mesh totals preserved exactly);
    replicated or maximum counters (crounds, rounds, maxd) replicate
    their maximum to every rank."""
    out = dict(totals)

    def place_sum(vec, dtype):
        v = np.asarray(vec, dtype=dtype)
        res = np.zeros((n_new,) + v.shape[1:], dtype=dtype)
        res[0] = v.sum(axis=0)
        return res

    def replicate_max(vec, dtype):
        v = np.asarray(vec, dtype=dtype)
        return np.full(n_new, v.max(initial=0), dtype=dtype)

    for k in CTR64:
        key = "pc_" + k
        if key not in out:
            continue
        out[key] = (replicate_max(out[key], np.int64) if k in _CTR64_MAX
                    else place_sum(out[key], np.int64)).tolist()
    if "pc_maxd" in out:
        out["pc_maxd"] = replicate_max(out["pc_maxd"], np.int32).tolist()
    for key in ("waste", "evals"):
        if key in out:
            out[key] = place_sum(np.asarray(out[key]).reshape(n_old, -1),
                                 np.int64).tolist()
    acc = np.asarray(acc, dtype=np.float64).reshape(n_old, -1)
    acc2 = np.zeros((n_new, acc.shape[1]), dtype=np.float64)
    # collapsing the partials re-associates the cross-rank sum, as the
    # reference's resize does
    acc2[0] = acc.sum(axis=0)
    out["acc_per_chip"] = acc2
    return out


@spmd_entry
def resume_family_walker_dd(path: str, family: str, theta: Sequence[float],
                            bounds, eps: float, mesh_resize: bool = False,
                            *, mesh: Mesh, **kwargs) -> W.WalkerResult:
    """Continue an interrupted checkpointed demand-driven run from its
    last leg snapshot (identity-checked, the mesh size included).
    ``kwargs`` are :func:`integrate_family_walker_dd`'s sizing and mode
    parameters, as the original run had them.

    ``mesh_resize=True`` resumes a snapshot of another world size onto
    this mesh: the live prefixes are re-dealt depth-stratified
    (``mesh.host_strided_redeal``, the host twin of the phase reshard),
    the per-rank totals reshard sum-preserving (:func:`_resize_dd_totals`)
    and the store sizing is recomputed. Without it a mismatch refuses."""
    theta_block = int(kwargs.get("theta_block", 1))
    rule = Rule(kwargs.get("rule", Rule.TRAPEZOID))
    theta_np, rep = W.normalize_theta_batch(theta, theta_block)
    m = theta_np.shape[0]
    bounds_np = np.asarray(bounds, dtype=np.float64)
    if bounds_np.ndim == 1:
        bounds_np = np.tile(bounds_np.reshape(1, 2), (m, 1))
    n_dev = mesh.size
    identity = _dd_ckpt_identity(
        family, float(eps), m, theta_np, bounds_np, n_dev, rule,
        int(kwargs.get("refill_slots", 0)),
        scout=W.resolve_scout_dtype(kwargs.get("scout_dtype"), rule),
        double_buffer=bool(kwargs.get("double_buffer", False)),
        reduced=bool(kwargs.get("reduced_integrands", False)),
        theta_block=theta_block)
    bag_cols, _count, acc, totals = load_family_checkpoint(
        path, identity, mesh_resize=mesh_resize)
    n_old = int(np.asarray(bag_cols["counts"]).shape[0])
    totals = dict(totals)
    fill_l = float(0.5 * (bounds_np[0, 0] + bounds_np[0, 1]))
    fill_th = float(rep[0])
    if n_old != n_dev:
        cols = {k: np.asarray(bag_cols[k]) for k in ("l", "r", "th", "meta")}
        dealt, new_counts = host_strided_redeal(
            cols, bag_cols["counts"], n_dev,
            fills={"l": fill_l, "r": fill_l, "th": fill_th, "meta": 0},
            # the phase boundary's depth stratification
            sort_key=np.asarray(bag_cols["meta"]) & DEPTH_MASK)
        bag_cols = dict(dealt, counts=new_counts)
        totals = _resize_dd_totals(totals, np.asarray(acc), n_old, n_dev)
        acc = np.asarray(totals["acc_per_chip"])

    _tl, _bc, store, _rw = _dd_sizing(
        int(kwargs.get("lanes", 1 << 12)),
        int(kwargs.get("capacity", 1 << 20)),
        int(kwargs.get("chunk", 1 << 12)),
        int(kwargs.get("roots_per_lane", 12)), theta_block)
    counts = np.asarray(bag_cols["counts"], dtype=np.int32)
    b = bag_cols["l"].shape[1]
    if b > store or int(counts.max(initial=0)) > store:
        raise ValueError(
            f"resume sizing mismatch: snapshot prefix width {b} (max "
            f"live count {int(counts.max(initial=0))}) does not fit the "
            f"store {store} computed from this call's lanes/capacity/"
            f"chunk/roots_per_lane; resume with the original run's "
            f"sizing parameters")
    r, dev = mesh.rank, mesh.device
    state = (device_store(store, fill_l, bag_cols["l"][r], device=dev),
             device_store(store, fill_l, bag_cols["r"][r], device=dev),
             device_store(store, fill_th, bag_cols["th"][r], device=dev),
             device_store(store, 0, bag_cols["meta"][r], torch.int32, dev),
             int(counts[r]))
    # the binary-exact npz accumulator, not the JSON round trip
    totals["acc_per_chip"] = np.asarray(acc)
    # snapshots from before the device counters: the pre-resume kernel
    # share, estimated now (walker.estimate_legacy_kernel_evals)
    totals.setdefault("est_kevals", W.estimate_legacy_kernel_evals(
        {"waste": totals.get("waste", [0] * W.N_WASTE),
         "sevals": int(np.sum(np.asarray(totals.get("evals", 0),
                                         dtype=np.int64))),
         "wtasks": int(np.sum(np.asarray(totals.get("pc_wtasks", [0]),
                                         dtype=np.int64))),
         "wsplits": int(np.sum(np.asarray(totals.get("pc_wsplits", [0]),
                                          dtype=np.int64))),
         "roots": int(np.sum(np.asarray(totals.get("pc_roots", [0]),
                                        dtype=np.int64)))}, rule))
    return integrate_family_walker_dd(
        family, theta, bounds, eps, mesh=mesh, checkpoint_path=path,
        _state_override=state, _totals_override=totals, **kwargs)


# ---------------------------------------------------------------------------
# The walker-dd stream's ranks
# ---------------------------------------------------------------------------

# the per-rank ints of a phase's one gather, before the family live counts
# and the partial areas: the cumulative counters, the lane-waste buckets,
# the eval split, then these
_ROW_TAIL = ("maxd", "count", "overflow", "syncs", "calls_sum",
             "calls_gather", "calls_rank", "k1_launches", "k2_launches")


def dd_row_layout(slots: int, m_eff: int) -> dict:
    """Column slices of a phase row (:meth:`DDStreamRank.phase_rows`):
    ``ctr`` (the 11 ``CTR64`` counters), ``waste``, ``evals``, one
    column per ``_ROW_TAIL`` name, ``fam_live`` (slots) and ``acc``
    (m_eff)."""
    out, j = {}, 0
    for k, w in (("ctr", len(CTR64)), ("waste", W.N_WASTE), ("evals", 2),
                 *((k, 1) for k in _ROW_TAIL), ("fam_live", slots),
                 ("acc", m_eff)):
        out[k] = slice(j, j + w)
        j += w
    out["width"] = j
    return out


class DDStreamRank:
    """One rank's part of the walker-dd stream, held by a persistent
    ``mesh.World`` across phases: the rank's bag store, partial areas and
    cumulative counters (a :class:`_DDCarry`), and the phase program
    (:func:`build_dd_walker_run` with ``max_cycles=1`` and the admit
    window). Every method runs on every rank in the same order (rank 0
    in the engine's process); the gathered results are rank 0's.

    ``cfg`` holds the engine's resolved configuration: ``family``,
    ``eps``, ``rule``, ``slots``, ``lanes``, ``capacity``, ``chunk``,
    ``roots_per_lane``, ``refill_slots``, ``seg_iters``,
    ``max_segments``, ``min_active_frac``, ``exit_frac``,
    ``suspend_frac``, ``sort_roots``, ``sort_skip_ratio``, ``scout``,
    ``double_buffer``, ``reduced``, ``theta_block``, ``fill`` and
    ``admit_window`` (per rank)."""

    def __init__(self, mesh: Mesh, cfg: dict):
        self.mesh = mesh
        T = int(cfg["theta_block"])
        self.slots = int(cfg["slots"])
        self.m_eff = self.slots * T
        target_local, breed_chunk, self.store, reshard_window = _dd_sizing(
            cfg["lanes"], cfg["capacity"], cfg["chunk"],
            cfg["roots_per_lane"])
        self.fill = tuple(float(v) for v in cfg["fill"])
        self.run = build_dd_walker_run(
            mesh, cfg["family"], float(cfg["eps"]), int(breed_chunk),
            int(cfg["capacity"]), self.slots, int(cfg["lanes"]),
            int(cfg["seg_iters"]), int(cfg["max_segments"]),
            float(cfg["min_active_frac"]), float(cfg["exit_frac"]),
            float(cfg["suspend_frac"]), int(target_local), 1,
            self.fill[0], self.fill[1], Rule(cfg["rule"]),
            bool(cfg["sort_roots"]), float(cfg["sort_skip_ratio"]),
            int(cfg["refill_slots"]), int(reshard_window),
            admit_window=int(cfg["admit_window"]), scout=bool(cfg["scout"]),
            double_buffer=bool(cfg["double_buffer"]),
            reduced=bool(cfg["reduced"]), theta_block=T)
        self.layout = dd_row_layout(self.slots, self.m_eff)
        self._launch0 = _launch_counts()
        self._set_state(None)

    def _set_state(self, st: Optional[dict]) -> None:
        """A fresh store, or this rank's row of a gathered snapshot
        ``st`` (:meth:`snapshot_rows`'s keys)."""
        r, dev = self.mesh.rank, self.mesh.device
        fx, fth = self.fill

        def block(k):
            return np.asarray(st["cols"][k])[r] if st else np.zeros(0)

        self.c = _DDCarry(
            bag_l=device_store(self.store, fx, block("l"), device=dev),
            bag_r=device_store(self.store, fx, block("r"), device=dev),
            bag_th=device_store(self.store, fth, block("th"), device=dev),
            bag_meta=device_store(self.store, 0, block("meta"), torch.int32,
                                  dev),
            count=int(st["counts"][r]) if st else 0,
            acc=(torch.tensor(np.asarray(st["acc"])[r], dtype=torch.float64,
                              device=dev) if st else
                 torch.zeros(self.m_eff, dtype=torch.float64, device=dev)),
            ctr={k: int(np.asarray(st["ctr"][j])[r]) if st else 0
                 for j, k in enumerate(CTR64)},
            waste=(np.asarray(st["waste"], dtype=np.int64)[r].copy() if st
                   else np.zeros(W.N_WASTE, dtype=np.int64)),
            evals=(np.asarray(st["evals"], dtype=np.int64)[r].copy() if st
                   else np.zeros(2, dtype=np.int64)),
            maxd=int(st["maxd"][r]) if st else 0,
            overflow=bool(st["ovf"][r]) if st else False)
        self.fam_live = torch.zeros(self.slots, dtype=torch.int32,
                                    device=dev)

    def phase(self, cmd: dict) -> None:
        """The phase's launch part on this rank: take this rank's row of
        the admitted (n, AW) block, its admit count and the recycled-slot
        mask (and the theta table in theta mode), then run one cycle."""
        r = self.mesh.rank
        blk = cmd["block"]
        tt = (None if cmd.get("theta") is None else
              torch.as_tensor(np.asarray(cmd["theta"]), dtype=torch.float64,
                              device=self.mesh.device))
        self.c, _cycles, _left, self.fam_live = self.run(
            self.c, (blk[0][r], blk[1][r], blk[2][r], blk[3][r],
                     int(cmd["counts"][r]), cmd["clear"]), theta_table=tt)

    def phase_rows(self) -> Optional[np.ndarray]:
        """The phase's pull part: ONE gather of every rank's counters,
        live counts and partial areas (float64: the integers are below
        2^53); rank 0 reads it (one sync) and gets the (n, width) rows."""
        c, mesh = self.c, self.mesh
        k1, k2 = _launch_counts()
        ints = [*(c.ctr[k] for k in CTR64), *c.waste, *c.evals, c.maxd,
                c.count, int(c.overflow), mesh.syncs.n,
                *(mesh.calls[k] for k in ("sum", "gather", "rank")),
                k1 - self._launch0[0], k2 - self._launch0[1]]
        dev = c.acc.device
        packed = torch.cat([
            torch.tensor(ints, dtype=torch.float64).to(dev),
            self.fam_live.to(torch.float64), c.acc])
        g = mesh.all_gather(packed)
        if mesh.rank:
            return None
        return mesh.syncs.pull_arrays(g)[0]

    def phase_all(self, cmd: dict) -> None:
        """A follower's whole phase: :meth:`phase`, then its part of the
        gather."""
        self.phase(cmd)
        self.phase_rows()

    def cancel(self, kill) -> Optional[np.ndarray]:
        """Deadline expiry: compact this rank's queue, dropping the
        killed slots' live rows (a stable partition, no collective), then
        gather the new counts; rank 0 gets the (n,) counts."""
        from ppls_tpu_torch.runtime.stream import _cancel_program
        c = self.c
        k = torch.as_tensor(np.asarray(kill), dtype=torch.bool,
                            device=c.acc.device)
        bag = _cancel_program(_local_bag(c, self.m_eff), k, self.mesh.syncs)
        self.c = dataclasses.replace(
            c, bag_l=bag.bag_l, bag_r=bag.bag_r, bag_th=bag.bag_th,
            bag_meta=bag.bag_meta, count=bag.count)
        counts = self.mesh.gather_host([bag.count])[:, 0]
        return counts if self.mesh.rank == 0 else None

    def snapshot_rows(self) -> Optional[dict]:
        """Every rank's live prefix (cut to the widest count, in rank
        order), partial areas and cumulative counters, gathered; rank 0
        gets them as host arrays."""
        c, mesh = self.c, self.mesh
        counts, _b, cols = gather_prefix(
            mesh, (c.bag_l, c.bag_r, c.bag_th, c.bag_meta), c.count,
            self.store)
        pc = mesh.gather_host([*(c.ctr[k] for k in CTR64), *c.waste,
                               *c.evals, c.maxd, int(c.overflow)])
        acc = gather_rows(mesh, c.acc)
        if mesh.rank:
            return None
        b = max(int(counts.max(initial=0)), 1)
        j = len(CTR64)
        return dict(
            cols=dict(zip(("l", "r", "th", "meta"),
                          (x[:, :b] for x in cols))),
            counts=counts, acc=acc,
            ctr=[pc[:, i] for i in range(j)],
            waste=pc[:, j:j + W.N_WASTE],
            evals=pc[:, j + W.N_WASTE:j + W.N_WASTE + 2],
            maxd=pc[:, -2], ovf=pc[:, -1].astype(bool))

    def restore(self, st: dict) -> None:
        """Overlay this rank's row of a snapshot (:meth:`snapshot_rows`'s
        keys, already on this world's size) on a fresh store."""
        self._set_state(st)
