"""The single-integral wavefront across devices: one frontier shard per
rank on ``torch.distributed`` (``mesh.py``).

The counterpart of the reference's ``parallel/sharded.py``, its
replacement for the C program's whole MPI layer (aquadPartA.c):

* the farmer's task dispatch -> the frontier lives split across ranks,
  one fixed-capacity shard each;
* the workers' accumulation -> a per-rank Neumaier pair; the host adds
  the ranks' pairs in rank order at the end;
* distributed termination (bag empty and every worker idle) -> the sum
  of the ranks' pending counts;
* demand-driven balance (the farmer's idle scan) -> every round each
  rank's children are gathered and rank d takes the global rows d,
  d + n, ... (``mesh.strided_reshard``), so refinement clustered in one
  rank's subdomain spreads at batch granularity.

The reference runs the rounds in one ``lax.while_loop`` under
``shard_map`` whose condition is a ``psum`` of pending counts. Here each
rank runs a host loop (:func:`run_sharded`); a round pays one collective
boundary, the deal, and every rank computes the loop condition and the
overflow flag from the deal's gathered header (every rank's child count),
so every rank takes the same branch. Split decisions are pointwise
float64, so tasks, splits, rounds and the per-rank histogram are the
reference's at the same world size.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ppls_tpu_torch.config import QuadConfig, Rule
from ppls_tpu_torch.models.integrands import get_integrand
from ppls_tpu_torch.ops.reduction import kahan_add
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK, eval_batch
from ppls_tpu_torch.parallel.bag_engine import _clear_snapshot
from ppls_tpu_torch.parallel.device_engine import compact_children
from ppls_tpu_torch.parallel.mesh import (Mesh, dealt_counts, spmd_entry,
                                          strided_reshard)
from ppls_tpu_torch.parallel.sharded_bag import gather_rows
from ppls_tpu_torch.runtime.checkpoint import (_config_identity,
                                               load_family_checkpoint,
                                               save_family_checkpoint)
from ppls_tpu_torch.utils.metrics import RunMetrics


@dataclasses.dataclass
class ShardState:
    """One rank's loop carry: its frontier shard on its device, its
    Neumaier pair, and host counters."""

    l: torch.Tensor          # (cap,) left endpoints
    r: torch.Tensor          # (cap,) right endpoints
    active: torch.Tensor     # (cap,) bool
    acc_s: torch.Tensor      # 0-dim f64 compensated sum of this rank's leaves
    acc_c: torch.Tensor
    n_active: int            # this rank's live rows (known from the deal)
    tasks: int = 0           # this rank's tasks (tasks_per_chip)
    splits: int = 0
    rounds: int = 0          # the same on every rank
    overflow: bool = False   # replicated


def _shard_round(mesh: Mesh, s: ShardState, f, eps: float, rule: Rule,
                 cap: int, fill: float):
    """One round: evaluate the local shard, accumulate its leaves, compact
    the children of its splits and deal every rank's children across the
    mesh. Returns ``(state, pending)``: the new state, whose ``overflow``
    is replicated, and the global pending count, both computed from the
    deal's gathered header on every rank."""
    value, _err, split = eval_batch(s.l, s.r, f, eps, rule)
    split = split & s.active
    accept = s.active & ~split
    leaf_sum = torch.sum(torch.where(accept, value, 0.0))
    acc_s, acc_c = kahan_add((s.acc_s, s.acc_c), leaf_sum)
    # 2 * cap slots: a shard's children never drop before the deal
    ch_l, ch_r, _act, n_children = compact_children(s.l, s.r, split,
                                                    2 * cap, fill)
    n_ch = int(mesh.syncs.pull(n_children))
    (new_l, new_r), mine, total, _header = strided_reshard(
        mesh, (ch_l, ch_r), n_ch, (fill, fill), cap)
    dealt = dealt_counts(total, mesh.size, cap)
    out = dataclasses.replace(
        s, l=new_l, r=new_r, active=mine, acc_s=acc_s, acc_c=acc_c,
        n_active=int(dealt[mesh.rank]), tasks=s.tasks + s.n_active,
        splits=s.splits + n_ch // 2, rounds=s.rounds + 1,
        overflow=s.overflow or total > mesh.size * cap)
    return out, int(dealt.sum())


def run_sharded(mesh: Mesh, s: ShardState, *, f, eps: float, rule: Rule,
                cap: int, max_rounds: int, stop_rounds: int,
                fill: float) -> ShardState:
    """The reference's ``build_sharded_run`` loop on one rank: rounds
    while the global pending count is positive, nothing overflowed and
    ``rounds`` is below ``max_rounds`` and the leg's ``stop_rounds``.
    One sum of the pending counts starts the leg; each round's deal
    carries the next one."""
    pending = mesh.psum_host([s.n_active])[0]
    while (pending > 0 and not s.overflow and s.rounds < max_rounds
           and s.rounds < stop_rounds):
        s, pending = _shard_round(mesh, s, f, eps, rule, cap, fill)
    return s


@dataclasses.dataclass
class ShardedResult:
    area: float
    metrics: RunMetrics
    exact: Optional[float] = None
    host_syncs: int = 0          # device reads by rank 0's host loop
    mesh: Optional[dict] = None  # transport and rank 0's collective calls

    @property
    def global_error(self) -> Optional[float]:
        return None if self.exact is None else abs(self.area - self.exact)


def _wavefront_identity(config: QuadConfig, n_dev: int) -> dict:
    ident = dict(_config_identity(config))
    ident["engine"] = "sharded-wavefront"
    ident["n_dev"] = n_dev       # per-rank state: the mesh size is identity
    return ident


def _seed_state(config: QuadConfig, mesh: Mesh, cap: int,
                fill: float) -> ShardState:
    """This rank's shard: [a, b] in rank 0's first slot, the fill value
    (an in-domain midpoint) everywhere else."""
    dev, dtype = mesh.device, getattr(torch, config.dtype)
    l = torch.full((cap,), fill, dtype=dtype, device=dev)
    r = torch.full((cap,), fill, dtype=dtype, device=dev)
    active = torch.zeros(cap, dtype=torch.bool, device=dev)
    if mesh.rank == 0:
        l[0], r[0], active[0] = config.a, config.b, True
    zero = torch.zeros((), dtype=dtype, device=dev)
    return ShardState(l=l, r=r, active=active, acc_s=zero,
                      acc_c=zero.clone(), n_active=int(mesh.rank == 0))


def sharded_integrate(config: QuadConfig = QuadConfig(),
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 8, *,
                      n_devices: Optional[int] = None, device="cuda",
                      mesh: Optional[Mesh] = None,
                      _state_override: Optional[dict] = None,
                      _crash_after_legs: Optional[int] = None
                      ) -> ShardedResult:
    """Integrate ``config`` across ranks (the module docstring). The world
    is ``n_devices`` ranks, else ``config.n_devices``, else every card
    (one rank on the CPU); ``device`` is CUDA by default (``"cpu"`` runs
    gloo ranks on the CPU). ``mesh.launch`` starts the ranks unless the
    call is made inside a process group. Each rank holds ``max(capacity
    // n, 8)`` frontier slots; a round whose children exceed every
    rank's slots raises.

    With ``checkpoint_path`` the run goes in legs of ``checkpoint_every``
    rounds, and each leg boundary snapshots every rank's full frontier
    columns (l, r, active: the child compaction depends on row position,
    so keeping the positions makes a resumed run replay the same rounds
    bit for bit), Neumaier pairs and counters, written by rank 0 in the
    reference's container. Resume with :func:`resume_sharded`."""
    if n_devices is None:
        n_devices = config.n_devices
    return _sharded_run(config, checkpoint_path, checkpoint_every,
                        n_devices=n_devices, device=device, mesh=mesh,
                        _state_override=_state_override,
                        _crash_after_legs=_crash_after_legs)


@spmd_entry
def _sharded_run(config: QuadConfig, checkpoint_path: Optional[str],
                 checkpoint_every: int, *, mesh: Mesh,
                 _state_override: Optional[dict] = None,
                 _crash_after_legs: Optional[int] = None) -> ShardedResult:
    n_dev = mesh.size
    cap = max(config.capacity // n_dev, 8)
    fill = 0.5 * (config.a + config.b)
    rule = Rule(config.rule)
    if _state_override is None:
        s = _seed_state(config, mesh, cap, fill)
    else:
        s = _resumed_state(_state_override, config, mesh)
    kw = dict(f=get_integrand(config.integrand).fn, eps=float(config.eps),
              rule=rule, cap=cap, max_rounds=int(config.max_rounds),
              fill=fill)
    t0 = time.perf_counter()
    legs = 0
    while True:
        # rounds advance in lockstep on every rank: the leg end agrees
        leg_end = (s.rounds + int(checkpoint_every) if checkpoint_path
                   else int(config.max_rounds))
        s = run_sharded(mesh, s, stop_rounds=leg_end, **kw)
        pending = mesh.psum_host([s.n_active])[0]
        finished = (pending == 0 or s.overflow
                    or s.rounds >= int(config.max_rounds))
        if checkpoint_path is None or finished:
            break
        _snapshot(mesh, checkpoint_path, _wavefront_identity(config, n_dev),
                  s)
        legs += 1
        if _crash_after_legs is not None and legs >= _crash_after_legs:
            raise RuntimeError(
                f"simulated crash after {legs} legs (test hook)")
    wall = time.perf_counter() - t0

    if s.overflow:
        raise RuntimeError(
            f"sharded frontier overflowed global capacity {n_dev * cap}; "
            f"raise config.capacity")
    if s.rounds >= config.max_rounds and pending > 0:
        raise RuntimeError(f"max_rounds={config.max_rounds} exceeded")
    if mesh.rank == 0:
        _clear_snapshot(checkpoint_path)
    pc = mesh.gather_host([s.tasks, s.splits])
    acc = gather_rows(mesh, torch.stack([s.acc_s, s.acc_c]).to(
        torch.float64))                                   # (n, 2)
    # the deterministic cross-rank reduction on the host, in rank order
    area = float(np.sum(acc[:, 0] + acc[:, 1]))
    tasks_per_chip = [int(t) for t in pc[:, 0]]
    tasks = sum(tasks_per_chip)
    splits = int(pc[:, 1].sum())
    metrics = RunMetrics(
        tasks=tasks, splits=splits, leaves=tasks - splits,
        rounds=s.rounds,
        # exact for a breadth-first wavefront: round r is depth r
        max_depth=max(s.rounds - 1, 0),
        integrand_evals=tasks * EVALS_PER_TASK[rule],
        wall_time_s=wall, n_chips=n_dev, tasks_per_chip=tasks_per_chip)
    return ShardedResult(
        area=area, metrics=metrics,
        exact=get_integrand(config.integrand).exact(config.a, config.b),
        host_syncs=mesh.syncs.n, mesh=mesh.record())


def _snapshot(mesh: Mesh, path: str, identity: dict, s: ShardState) -> None:
    """Gather every rank's full columns, Neumaier pair and counters; rank
    0 writes the snapshot, then every rank waits for it."""
    cols = gather_rows(mesh, torch.stack([
        s.l.to(torch.float64), s.r.to(torch.float64),
        s.active.to(torch.float64)]))                     # (n, 3, cap)
    acc = gather_rows(mesh, torch.stack([s.acc_s, s.acc_c]).to(
        torch.float64))                                   # (n, 2)
    pc = mesh.gather_host([s.tasks, s.splits])
    if mesh.rank == 0:
        active = cols[:, 2, :].astype(bool)
        save_family_checkpoint(
            path, identity=identity,
            bag_cols={"l": cols[:, 0, :], "r": cols[:, 1, :],
                      "active": active},
            count=int(active.sum()), acc=acc.T,
            totals={"pc_tasks": pc[:, 0].tolist(),
                    "pc_splits": pc[:, 1].tolist(),
                    "rounds": s.rounds})
    mesh.barrier()


def _resumed_state(snap: dict, config: QuadConfig, mesh: Mesh
                   ) -> ShardState:
    """This rank's row of a loaded snapshot, on its device."""
    r, dev = mesh.rank, mesh.device
    dtype = getattr(torch, config.dtype)
    cols, acc, totals = snap["cols"], snap["acc"], snap["totals"]
    active = np.asarray(cols["active"][r], dtype=bool)
    return ShardState(
        l=torch.as_tensor(cols["l"][r], dtype=dtype).to(dev),
        r=torch.as_tensor(cols["r"][r], dtype=dtype).to(dev),
        active=torch.as_tensor(active).to(dev),
        acc_s=torch.tensor(acc[0, r], dtype=dtype, device=dev),
        acc_c=torch.tensor(acc[1, r], dtype=dtype, device=dev),
        n_active=int(active.sum()), tasks=int(totals["pc_tasks"][r]),
        splits=int(totals["pc_splits"][r]), rounds=int(totals["rounds"]))


def resume_sharded(path: str, config: QuadConfig,
                   checkpoint_every: int = 8, *,
                   n_devices: Optional[int] = None, device="cuda",
                   mesh: Optional[Mesh] = None) -> ShardedResult:
    """Continue an interrupted checkpointed :func:`sharded_integrate` run
    from its last leg snapshot (identity-checked, the mesh size
    included), bit-identical to the uninterrupted run: every rank's full
    columns, Neumaier pair and counters re-enter its device unchanged."""
    if n_devices is None:
        n_devices = config.n_devices
    return _resume_run(path, config, checkpoint_every, n_devices=n_devices,
                       device=device, mesh=mesh)


@spmd_entry
def _resume_run(path: str, config: QuadConfig, checkpoint_every: int, *,
                mesh: Mesh) -> ShardedResult:
    n_dev = mesh.size
    cols, _count, acc, totals = load_family_checkpoint(
        path, _wavefront_identity(config, n_dev))
    cap = max(config.capacity // n_dev, 8)
    if cols["l"].shape != (n_dev, cap):
        raise ValueError(
            f"resume sizing mismatch: snapshot frontier shape "
            f"{cols['l'].shape} does not match (n_dev, cap) = "
            f"({n_dev}, {cap}) from this call's capacity; resume with "
            f"the original run's capacity")
    return _sharded_run(config, path, checkpoint_every, mesh=mesh,
                        _state_override=dict(cols=cols, acc=acc,
                                             totals=totals))
