"""Device-resident wavefront engine (the reference's
``parallel/device_engine.py``).

The whole adaptive loop (evaluate, accumulate, compact, terminate) keeps
its state on the device: a fixed-capacity pair of coordinate arrays and
an active mask, a Neumaier-compensated accumulator, and the counters.
The bag's push is a cumsum scatter-compaction (:func:`compact_children`);
termination is "no active lane".

The reference runs every round in one ``lax.while_loop`` and reads the
device once. PyTorch has no device-side loop condition, so the host
launches rounds in blocks of ``READ_EVERY`` and reads the loop condition
(with the small fields) once per block: a round whose condition is
false is a no-op, so the counters, ``rounds`` among them, come out as
the reference's. The reads are counted (``DeviceResult.host_syncs``).

When a round would produce more children than ``capacity`` the engine
sets its overflow flag; ``device_integrate`` then reruns the problem on
the host-driven engine (``runtime/host_frontier.py``, the same device),
as the reference does, or raises with ``fallback=False``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import torch

from ppls_tpu_torch.config import QuadConfig, Rule
from ppls_tpu_torch.models.integrands import get_integrand
from ppls_tpu_torch.ops.reduction import kahan_add, kahan_init, masked_sum
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK, eval_batch
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device
from ppls_tpu_torch.utils.metrics import RunMetrics

# rounds launched between two reads of the loop condition
READ_EVERY = 16


@dataclasses.dataclass
class DeviceState:
    """The loop carry; every field lives on the device."""

    l: torch.Tensor          # (capacity,) left endpoints
    r: torch.Tensor          # (capacity,) right endpoints
    active: torch.Tensor     # (capacity,) bool: the lane holds an interval
    acc_s: torch.Tensor      # 0-dim compensated sum of accepted areas
    acc_c: torch.Tensor      # 0-dim compensation
    tasks: torch.Tensor      # 0-dim i64 intervals evaluated
    splits: torch.Tensor     # 0-dim i64 intervals refined
    rounds: torch.Tensor     # 0-dim i64 rounds completed
    overflow: torch.Tensor   # 0-dim bool: a round needed > capacity slots


def compact_children(l: torch.Tensor, r: torch.Tensor, split: torch.Tensor,
                     capacity: int, fill: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Scatter both halves of every split interval into a dense prefix:
    split interval k (in lane order) writes [l, mid] to slot 2k and
    [mid, r] to slot 2k + 1. ``fill`` pads the other slots and must lie
    in the integrand's domain (masked lanes still evaluate it).

    Returns ``(new_l, new_r, new_active, n_children)``. Children whose
    slot is >= ``capacity`` are dropped (the caller compares n_children
    with capacity): they go to one extra slot past the end of a
    ``capacity + 1`` buffer, which is cut off, since an out-of-range
    index would be a device-side error in PyTorch, not a drop."""
    idx = torch.cumsum(split.to(torch.int64), 0) - 1
    n_children = 2 * split.to(torch.int64).sum()
    mid = (l + r) * 0.5
    left = 2 * idx
    right = left + 1
    left_slot = torch.where(split & (left < capacity), left, capacity)
    right_slot = torch.where(split & (right < capacity), right, capacity)
    new_l = torch.full((capacity + 1,), fill, dtype=l.dtype, device=l.device)
    new_r = torch.full((capacity + 1,), fill, dtype=r.dtype, device=r.device)
    new_l[left_slot] = l
    new_r[left_slot] = mid
    new_l[right_slot] = mid
    new_r[right_slot] = r
    new_active = torch.arange(capacity, device=l.device) < n_children
    return new_l[:capacity], new_r[:capacity], new_active, n_children


def initial_state(a: float, b: float, capacity: int,
                  dtype=torch.float64, device="cuda") -> DeviceState:
    """The frontier seeded with [a, b] on ``device`` (CUDA by default,
    raising without a card unless ``device="cpu"``); the other slots
    hold the midpoint, an in-domain value."""
    device = resolve_device(device)
    fill = 0.5 * (a + b)
    l = torch.full((capacity,), fill, dtype=dtype, device=device)
    r = torch.full((capacity,), fill, dtype=dtype, device=device)
    l[0] = a
    r[0] = b
    active = torch.zeros(capacity, dtype=torch.bool, device=device)
    active[0] = True

    def zero(dt):
        return torch.zeros((), dtype=dt, device=device)

    acc_s, acc_c = kahan_init(dtype, device)
    return DeviceState(l=l, r=r, active=active, acc_s=acc_s,
                       acc_c=acc_c, tasks=zero(torch.int64),
                       splits=zero(torch.int64), rounds=zero(torch.int64),
                       overflow=zero(torch.bool))


def round_body(state: DeviceState, f: Callable, eps: float, rule: Rule,
               capacity: int, fill: float = 1.0) -> DeviceState:
    """One wavefront round: evaluate -> accumulate -> compact."""
    value, _err, split = eval_batch(state.l, state.r, f, eps, rule)
    split = split & state.active
    accept = state.active & ~split
    acc_s, acc_c = kahan_add((state.acc_s, state.acc_c),
                             masked_sum(value, accept))
    n_active = state.active.to(torch.int64).sum()
    n_split = split.to(torch.int64).sum()
    new_l, new_r, new_active, n_children = compact_children(
        state.l, state.r, split, capacity, fill)
    return DeviceState(
        l=new_l, r=new_r, active=new_active, acc_s=acc_s, acc_c=acc_c,
        tasks=state.tasks + n_active, splits=state.splits + n_split,
        rounds=state.rounds + 1,
        overflow=state.overflow | (n_children > capacity))


def _loop_cond(state: DeviceState, max_rounds: int) -> torch.Tensor:
    """The reference's ``while_loop`` condition, as a 0-dim bool."""
    return state.active.any() & ~state.overflow \
        & (state.rounds < max_rounds)


def _guarded_round(state: DeviceState, f: Callable, eps: float,
                   rule: Rule, capacity: int, fill: float,
                   max_rounds: int) -> DeviceState:
    """:func:`round_body` where the loop condition holds, the state
    unchanged where it does not."""
    go = _loop_cond(state, max_rounds)
    new = round_body(state, f, eps, rule, capacity, fill)
    return DeviceState(**{
        k: torch.where(go, getattr(new, k), getattr(state, k))
        for k in DeviceState.__dataclass_fields__})


def _run(state: DeviceState, *, f: Callable, eps: float, rule: Rule,
         capacity: int, max_rounds: int, fill: float, syncs: HostSyncs):
    """Rounds until the loop condition fails, reading it (with the small
    fields) once every ``READ_EVERY`` rounds. Returns the final state and
    its host values ``(acc_s, acc_c, tasks, splits, rounds, overflow,
    any_active)``."""
    launched = 0
    while True:
        for _ in range(min(READ_EVERY, max(max_rounds - launched, 1))):
            state = _guarded_round(state, f, eps, rule, capacity, fill,
                                   max_rounds)
            launched += 1
        packed = torch.stack([
            state.acc_s.to(torch.float64), state.acc_c.to(torch.float64),
            state.tasks.to(torch.float64), state.splits.to(torch.float64),
            state.rounds.to(torch.float64),
            state.overflow.to(torch.float64),
            state.active.any().to(torch.float64),
            _loop_cond(state, max_rounds).to(torch.float64)])
        (vals,) = syncs.pull_arrays(packed)
        if not vals[7]:
            acc_s, acc_c = float(vals[0]), float(vals[1])
            return state, (acc_s, acc_c, int(vals[2]), int(vals[3]),
                           int(vals[4]), bool(vals[5]), bool(vals[6]))


@dataclasses.dataclass
class DeviceResult:
    area: float
    # None when the device run overflowed and the result came from the
    # host-engine rerun (the overflowed device state is not meaningful)
    state: Optional[DeviceState]
    metrics: RunMetrics
    exact: Optional[float] = None
    host_syncs: int = 0          # device reads by the host loop

    @property
    def global_error(self) -> Optional[float]:
        return None if self.exact is None else abs(self.area - self.exact)


def device_integrate(config: QuadConfig = QuadConfig(),
                     fallback: bool = True, device="cuda") -> DeviceResult:
    """Run the adaptive integration with the state on ``device`` (CUDA by
    default; raises without a card unless ``device="cpu"``).

    If the fixed-capacity frontier overflows and ``fallback`` is True,
    the run restarts on the host-driven engine (unbounded frontier) on
    the same device; with ``fallback=False`` it raises."""
    from ppls_tpu_torch.obs.telemetry import default_telemetry

    dev = resolve_device(device)
    entry = get_integrand(config.integrand)
    rule = Rule(config.rule)
    syncs = HostSyncs()
    state = initial_state(config.a, config.b, config.capacity,
                          dtype=getattr(torch, config.dtype), device=dev)
    t0 = time.perf_counter()
    out, (acc_s, acc_c, tasks, splits, rounds, overflow, any_active) = _run(
        state, f=entry.fn, eps=float(config.eps), rule=rule,
        capacity=int(config.capacity), max_rounds=int(config.max_rounds),
        fill=0.5 * (config.a + config.b), syncs=syncs)
    wall = time.perf_counter() - t0

    if overflow:
        if not fallback:
            raise RuntimeError(
                f"device frontier overflowed capacity={config.capacity}; "
                f"raise capacity or use the host engine")
        from ppls_tpu_torch.runtime.host_frontier import integrate
        host = integrate(config, device=dev)
        # the wasted device attempt is charged to the wall
        metrics = host.metrics
        metrics.wall_time_s += wall
        return DeviceResult(area=host.area, state=None, metrics=metrics,
                            exact=host.exact,
                            host_syncs=syncs.n + host.host_syncs)

    if rounds >= config.max_rounds and any_active:
        raise RuntimeError(f"max_rounds={config.max_rounds} exceeded")

    metrics = RunMetrics(
        tasks=tasks, splits=splits, leaves=tasks - splits, rounds=rounds,
        # exact for a breadth-first wavefront: round r is depth r
        max_depth=max(rounds - 1, 0),
        integrand_evals=tasks * EVALS_PER_TASK[rule],
        wall_time_s=wall, n_chips=1, tasks_per_chip=[tasks])
    default_telemetry().publish_run("device", metrics)
    return DeviceResult(area=acc_s + acc_c, state=out, metrics=metrics,
                        exact=entry.exact(config.a, config.b),
                        host_syncs=syncs.n)
