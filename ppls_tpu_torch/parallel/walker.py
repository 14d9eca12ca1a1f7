"""Depth-first subtree walker: the flagship family engine.

Each of ``lanes`` SIMD lanes walks one root interval's whole refinement
subtree depth-first with the implicit binary-tree address (i, d): the
current node of root [A, A+W] is [A + i W 2^-d, A + (i+1) W 2^-d].
Descend is ``i <<= 1``; advance after an accepted leaf strips trailing
ones. The split test and the leaf values are double-single float32
(``ops/ds_kernel.py``), accumulated lane-locally; per-family credit is
an exact segment sum at phase boundaries. Three step machines: the
trapezoid test, the float32-scouting trapezoid test, and Simpson with
Richardson extrapolation.

Each engine cycle (:func:`_cycle_once`):

1. BREED: the float64 bag engine refines the seed intervals until the
   bag holds enough roots (``_breed``).
2. SORT: the top of the queue is ordered by a one-step error estimate,
   a proxy for subtree work (``_order_roots_by_work``).
3. WALK, in one of two modes:

   * in-kernel refill (``refill_slots`` = R > 0): the sorted roots are
     dealt round-robin into per-lane private root banks
     (``deal_root_bank``) and the K1 segment kernel walks the lanes and
     refills them from their banks itself (``run_segment_rf``), launch
     after launch until the bank is dry and occupancy falls to the
     suspension floor (``_run_walk_kernel_refill``, optionally with
     double-buffered half-banks);
   * boundary refill (``refill_slots=0``, the default): the K2 segment
     kernel walks until occupancy falls to a threshold
     (``run_segment_ee``), then the host banks finished lanes and hands
     them fresh roots off the queue top (``_bank_and_refill``), segment
     after segment (``_run_walk``).

   Each kernel runs as CUDA on the card and as its plain PyTorch
   segment on the CPU.
4. CREDIT, EXPAND, DRAIN: exact segment sums credit every family;
   suspended walks and untaken roots go back into the bag as explicit
   tasks (``_expand_pending``); a small remainder drains in float64.

The reference runs each phase as one compiled ``while_loop``. This port
runs a host Python loop over device-resident tensors; the points where
it reads a device value are counted (``WalkerResult.host_syncs``).

K3 (``run_segment``), a fixed number of steps with no counters, is the
kernel-ceiling probe's segment (``ppls_tpu_torch/tools/profile_walker.py``).

Theta mode (``theta_block`` = T > 1, in-kernel refill and the trapezoid
test only): theta is an (m, T) table, each frontier root is dealt to a
group of T adjacent lanes that walk it together with T thetas, the
group splits a node when any unretired lane's own test fails (the union
vote), a lane whose own test passed credits its value there and retires
for the subtree (its accept marker ``mk_i``/``mk_d``), and credit lands
in m * T accumulators. Breeding only splits, and the float64 drain is
the union-refinement bag round (``_theta_bag_round``).

The streaming engine (``runtime/stream.py``) runs one cycle per phase
through :func:`run_stream_cycle`.

Checkpoints: with ``checkpoint_path`` the run snapshots the live bag
prefix, the accumulator and the totals at cycle edges, where every lane
and bank has been folded back into the bag, in the reference's
container (``runtime/checkpoint.py``); :func:`resume_family_walker`
continues it bit-identically, from a snapshot of either package.

The reference bench's pipeline: :func:`seed_family_walker_state` builds
a seed bag once, :func:`dispatch_family_walker` validates and queues a
run on it, :func:`collect_family_walker` walks it. The host loop reads
the device inside every cycle, so a queued run cannot run ahead of the
host; the results and the meaning of ``wall_time_s`` are the
reference's. Across devices the same phases run per rank under the
demand-driven cycle of ``sharded_walker.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import check_ds_domain, family_name_of
from ppls_tpu_torch.ops import ds_kernel as dsk
from ppls_tpu_torch.ops import scout_kernel
from ppls_tpu_torch.ops.ds import ds_from_f64, ds_to_f64
from ppls_tpu_torch.ops.ds_kernel import f32
from ppls_tpu_torch.ops.pow2 import pow2_f32, pow2_f64
from ppls_tpu_torch.ops.reduction import kahan_add, segment_sum_auto
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK, eval_batch
from ppls_tpu_torch.parallel.bag_engine import (
    ACCEPT_BIT, DEPTH_BITS, DEPTH_MASK, MAX_FAMILIES, BagState,
    _clear_snapshot, _family_ckpt_identity, _family_problem, _pull_prefix,
    _restore_bag, bag_step, dyn_slice, dyn_update, initial_bag, run_bag)
from ppls_tpu_torch.runtime.checkpoint import (
    engine_name, load_family_checkpoint, save_family_checkpoint)
from ppls_tpu_torch.runtime.tune import (resolve_cadence_tuned,
                                         workload_signature)
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device
from ppls_tpu_torch.utils.metrics import RunMetrics, round_stats_from_rows

DEFAULT_LANES = 1 << 14
MAX_REL_DEPTH = 30          # i must stay in int32 (csrc/walk_step.cuh too)

# lane flag bits (csrc/walk_step.cuh)
_MODE_LOAD = 1              # next eval reloads f(right)
_PARKED = 2                 # lane finished its root (or has none)
_NO_ROOT = 4                # lane has no root assigned (idle)
_OVF = 8                    # parked on depth overflow: not refilled, its
#                             pending (i, d) set feeds the mop-up
_MODE_INIT = 16             # fresh root: next eval is f(left)
_MODE_LOADM = 32            # Simpson only: next eval loads f(mid)
_MODE_TESTB = 64            # Simpson only: q1 is stashed, next eval is
#                             q3 and the split decision fires

# step machines, a template parameter of every kernel (csrc/walk_step.cuh)
STEP_TRAP, STEP_SCOUT, STEP_SIMPSON = 0, 1, 2


def step_mode(rule: Rule, scout: bool) -> int:
    """The step machine of a walk: scouting (trapezoid only), Simpson or
    the trapezoid test."""
    if scout:
        if Rule(rule) != Rule.TRAPEZOID:
            raise ValueError("scout mode supports Rule.TRAPEZOID only")
        return STEP_SCOUT
    return STEP_SIMPSON if Rule(rule) == Rule.SIMPSON else STEP_TRAP


def _dsc(x: float) -> Tuple[float, float]:
    """A float64 constant as two float32 limbs (hi, lo)."""
    hi = f32(x)
    return hi, f32(x - hi)


# Simpson + Richardson scalings as ds constants: a float32 literal
# carries 3e-8 relative error, which would land systematically on every
# accepted value (csrc/walk_step.cuh K_SIXTH_* etc. spell the same limbs)
SIMPSON_SIXTH = _dsc(1.0 / 6.0)
SIMPSON_TWELFTH = _dsc(1.0 / 12.0)
SIMPSON_FIFTEENTH = _dsc(1.0 / 15.0)

# scout guard band: 64 float32 ulps of the test's magnitude sum
SCOUT_GUARD_ULPS = 64.0
_SCOUT_BAND = f32(SCOUT_GUARD_ULPS * 2.0 ** -23)

# the root sort is skipped when every live root's one-step error is
# within this ratio of the others (~one refinement level: trapezoid
# errors fall ~8x per level)
SORT_SKIP_RATIO = 8.0

S_CAP = 1024    # per-segment stats rows kept (later segments overwrite
#                 the last row)
C_CAP = 64      # per-cycle stats rows kept
SEG_STAT_FIELDS = ("steps", "live_at_exit", "queue_left", "refilled")
# Lane-waste buckets: every kernel lane-step lands in exactly one, so
# their sums reconcile to lanes x kernel steps.
WASTE_FIELDS = ("eval_active", "masked_dead", "refill_stall",
                "drain_tail", "theta_overwalk")
N_WASTE = len(WASTE_FIELDS)
# Kernel eval split: float32 scout evals, ds confirm evals.
EVAL_FIELDS = ("scout_evals", "confirm_evals")
CYCLE_STAT_FIELDS = ("bred_roots", "breed_iters", "roots_consumed",
                     "walker_tasks", "walker_steps", "segments",
                     "expand_tasks", "drain_tasks", "sort_rows",
                     "tasks", "splits") + WASTE_FIELDS + EVAL_FIELDS


@functools.lru_cache(maxsize=None)
def scout_twin(f_ds: Callable) -> Callable:
    """The float32 scout evaluator of a ds twin (the same integrand
    through ``ops/scout_kernel.py``), with a stable identity."""
    def f_scout(x, th):
        return f_ds(x, th, dsm=scout_kernel)

    return f_scout


def _is_reduced_twin(f_ds: Callable) -> bool:
    """Whether ``f_ds`` is a registered range-reduced ds twin. The walker
    receives the twin itself, so membership in the registry is the
    detection; the reduced schedule is a checkpoint identity key
    (``_walker_identity``)."""
    from ppls_tpu_torch.models.integrands import DS_FAMILIES_REDUCED
    return any(f_ds is v for v in DS_FAMILIES_REDUCED.values())


def resolve_scout_dtype(scout_dtype: Optional[str], rule: Rule) -> bool:
    """``"f32"`` turns on two-pass scouting, ``"f64"`` or None leaves it
    off (the reference's PPLS_SCOUT environment lane is not carried)."""
    if scout_dtype is None:
        return False
    if scout_dtype not in ("f64", "f32"):
        raise ValueError(f"scout_dtype must be 'f64' (off) or 'f32', got "
                         f"{scout_dtype!r}")
    if scout_dtype == "f32" and Rule(rule) != Rule.TRAPEZOID:
        raise ValueError("scout_dtype='f32' supports Rule.TRAPEZOID only")
    return scout_dtype == "f32"


def validate_double_buffer(double_buffer: bool, refill_slots: int) -> None:
    if double_buffer and (refill_slots < 2 or refill_slots % 2):
        raise ValueError(f"double_buffer requires an even refill_slots "
                         f">= 2, got {refill_slots}")


def resolve_cadence(exit_frac: Optional[float],
                    suspend_frac: Optional[float], scout: bool,
                    refill_slots: int = 0, *, signature=None,
                    device="cuda") -> Tuple[float, float]:
    """The refill cadence, as the reference resolves it
    (``runtime/tune.py``): explicit values win; otherwise the tuning
    table's rows for ``device`` (exact signature, then nearest), then
    the hand-tuned tier: exit 0.95 / suspend 0.65 with scouting and
    in-kernel refill, 0.80 / 0.50 without. ``signature`` is a
    ``tune.workload_signature`` dict, or None to skip the table."""
    exit_frac, suspend_frac, _tier = resolve_cadence_tuned(
        exit_frac, suspend_frac, scout, refill_slots, signature=signature,
        device=device)
    return float(exit_frac), float(suspend_frac)


def validate_theta_block(theta_block: int, *, lanes: int,
                         refill_slots: int, rule: Rule, m: int) -> int:
    """The preconditions of theta mode (the reference's checks and
    messages): T a power of two dividing ``lanes``, in-kernel refill,
    the trapezoid rule, and m * T families within the meta word.
    Returns T."""
    T = int(theta_block)
    if T < 1:
        raise ValueError(f"theta_block must be >= 1, got {T}")
    if T == 1:
        return T
    if T & (T - 1):
        raise ValueError(f"theta_block must be a power of two, got {T}")
    if lanes % T:
        raise ValueError(
            f"theta_block={T} must divide lanes={lanes} (each theta "
            f"block occupies T adjacent minor-axis lanes)")
    if not refill_slots:
        raise ValueError(
            "theta_block > 1 requires refill_slots > 0 (the theta "
            "groups take roots together through the in-kernel refill "
            "deal; the legacy XLA-boundary refill permutes lanes "
            "individually and would scramble the groups)")
    if Rule(rule) != Rule.TRAPEZOID:
        raise ValueError(
            "theta_block > 1 supports Rule.TRAPEZOID only (the Simpson "
            "walker's 5-phase mode chain has no union-vote step)")
    if m * T > MAX_FAMILIES:
        raise ValueError(
            f"slots * theta_block = {m} * {T} exceeds the meta-word "
            f"fam field ({MAX_FAMILIES})")
    return T


def normalize_theta_batch(theta, theta_block: int):
    """``(theta2d, rep)``: the (m, T) float64 theta table and the (m,)
    representative column ``theta2d[:, 0]`` that frontier bag rows carry
    for the work sort. T = 1 takes an (m,) theta; T > 1 an (m, T) one,
    or a bare (T,) vector for m = 1."""
    theta = np.asarray(theta, dtype=np.float64)
    T = int(theta_block)
    if T == 1:
        return theta.reshape(-1, 1), theta.reshape(-1)
    if theta.ndim == 1:
        if theta.shape[0] != T:
            raise ValueError(
                f"theta_block={T}: 1-D theta must have exactly T "
                f"entries (the m=1 convenience), got {theta.shape[0]}")
        theta = theta.reshape(1, T)
    if theta.ndim != 2 or theta.shape[1] != T:
        raise ValueError(
            f"theta_block={T}: theta must be (m, {T}), got "
            f"{theta.shape}")
    return theta, theta[:, 0].copy()


def theta_drain_chunk(breed_chunk: int, theta_block: int) -> int:
    """The union-refinement drain's pop width: its exact segment sum
    credits chunk * T rows per round, kept near 2^16."""
    return max(1, min(breed_chunk, (1 << 16) // theta_block))


def theta_breed_target(target: int, refill_slots: int, lanes: int,
                       theta_block: int) -> int:
    """Theta mode's breed target: split-only breeding finishes no work,
    so it must not outrun one deal (R roots per theta group), or the
    undealt remainder would grow every cycle."""
    return min(target, max(1, refill_slots) * (lanes // theta_block))


def _group_any(mask: torch.Tensor, theta_block: int) -> torch.Tensor:
    """Any over each theta group of T adjacent lanes, broadcast back to
    every lane of the group: the union vote."""
    g = mask.reshape(-1, theta_block)
    return g.any(dim=1, keepdim=True).expand(g.shape).reshape(mask.shape)


def _theta_retired(s: "WalkState") -> torch.Tensor:
    """Theta lanes retired for the group's current node: it lies in the
    subtree of the lane's accept marker (mk_i, mk_d), set where the
    lane's own test passed but its group split. DFS node indexes at any
    depth only grow in visit order, so a stale marker never matches a
    later subtree; a refill resets the markers."""
    dd = s.d - s.mk_d
    anc = s.i >> torch.clamp(dd, 0, 31)
    return (s.mk_d >= 0) & (dd >= 0) & (anc == s.mk_i)


class WalkState(NamedTuple):
    """Per-lane walker state, every field a (lanes,) tensor; lane l is
    the reference's (row, col) = divmod(l, 128). ``fm``/``fq`` are
    Simpson caches the trapezoid walk carries untouched; ``mk_i``/
    ``mk_d`` are theta mode's accept markers (0 / -1 when unset)."""

    a_h: torch.Tensor        # root left endpoint (ds, float32 limbs)
    a_l: torch.Tensor
    w_h: torch.Tensor        # root width (ds)
    w_l: torch.Tensor
    th_h: torch.Tensor       # integrand parameter (ds)
    th_l: torch.Tensor
    fl_h: torch.Tensor       # cached f(left endpoint of current node)
    fl_l: torch.Tensor
    fr_h: torch.Tensor       # cached f(right endpoint of current node)
    fr_l: torch.Tensor
    fm_h: torch.Tensor
    fm_l: torch.Tensor
    fq_h: torch.Tensor
    fq_l: torch.Tensor
    acc_h: torch.Tensor      # ds accumulator of the current root
    acc_l: torch.Tensor
    i: torch.Tensor          # int32 node index at depth d
    d: torch.Tensor          # int32 depth relative to the root
    base_d: torch.Tensor     # int32 absolute depth of the root
    fam: torch.Tensor        # int32 family of the current root
    flags: torch.Tensor      # int32 mode/parked/no-root bits
    tasks: torch.Tensor      # int32 tasks evaluated by this lane
    splits: torch.Tensor     # int32
    maxd: torch.Tensor       # int32 max absolute depth seen
    mk_i: torch.Tensor       # int32 theta accept marker node (0: unset)
    mk_d: torch.Tensor       # int32 its depth (-1: unset)


N_F32_FIELDS = 16            # the first 16 WalkState fields are float32


def _fresh_lanes(lanes: int, device) -> WalkState:
    z32 = torch.zeros(lanes, dtype=torch.float32, device=device)
    zi = torch.zeros(lanes, dtype=torch.int32, device=device)
    ones = torch.ones(lanes, dtype=torch.float32, device=device)
    return WalkState(
        a_h=ones, a_l=z32, w_h=ones.clone(), w_l=z32.clone(),
        th_h=ones.clone(), th_l=z32.clone(),
        fl_h=z32.clone(), fl_l=z32.clone(), fr_h=z32.clone(),
        fr_l=z32.clone(), fm_h=z32.clone(), fm_l=z32.clone(),
        fq_h=z32.clone(), fq_l=z32.clone(), acc_h=z32.clone(),
        acc_l=z32.clone(), i=zi, d=zi.clone(), base_d=zi.clone(),
        fam=zi.clone(),
        flags=torch.full((lanes,), _PARKED | _NO_ROOT, dtype=torch.int32,
                         device=device),
        tasks=zi.clone(), splits=zi.clone(), maxd=zi.clone(),
        mk_i=zi.clone(),
        mk_d=torch.full((lanes,), -1, dtype=torch.int32, device=device))


def _fresh_sentinel(lanes: int, device):
    """A zeroed sentinel result row (resm_h, resm_l, resm_fam)."""
    return (torch.zeros(lanes, dtype=torch.float32, device=device),
            torch.zeros(lanes, dtype=torch.float32, device=device),
            torch.zeros(lanes, dtype=torch.int32, device=device))


def _node_geometry(s: WalkState):
    """Dyadic coordinates of the current node from (i, d), rebuilt from
    scratch each step so coordinate error does not accumulate."""
    scale = pow2_f32(-s.d)
    w = (s.w_h * scale, s.w_l * scale)
    il = (s.i & 0x7FFF).to(torch.float32)             # two exact limbs
    ih = (s.i >> 15).to(torch.float32)
    step = dsk.ds_add(dsk.ds_mul_f32(dsk.ds_mul_pow2(w, 32768.0), ih),
                      dsk.ds_mul_f32(w, il))
    x0 = dsk.ds_add((s.a_h, s.a_l), step)
    x1 = dsk.ds_add(x0, w)
    return w, x0, x1


def _ctz(k: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of a positive int32 via the float32
    exponent."""
    low = k & (-k)
    return (low.to(torch.float32).view(torch.int32) >> 23) - 127


# ---------------------------------------------------------------------------
# K1, plain PyTorch version: the in-kernel-refill segment
# ---------------------------------------------------------------------------


def _finish_step(s: WalkState, testing, split, val, theta_block: int = 1,
                 test_act=None):
    """Shared tail of every step: credit, DFS advance, counters.

    Outside theta mode a lane splits on its own ``split``, and a split
    past MAX_REL_DEPTH parks it as OVF. In theta mode (T > 1; the
    unretired testing lanes ``test_act``) the group splits when any of
    its unretired lanes votes to, a split past the depth cap is accepted
    by the whole group instead, each lane credits its own value where its
    own test passed (or at the cap), and a lane that credits while its
    group splits sets its accept marker."""
    if theta_block > 1:
        vote = test_act & split
        do_split = testing & _group_any(vote, theta_block)
        ovf_force = do_split & (s.d >= MAX_REL_DEPTH)
        do_split = do_split & ~ovf_force
        ovf = torch.zeros_like(do_split)
        accept = testing & ~do_split
        credit = test_act & (~split | ovf_force)
        split_inc = vote & do_split
        task_inc = test_act
    else:
        do_split = testing & split
        ovf = do_split & (s.d >= MAX_REL_DEPTH)
        do_split = do_split & ~ovf
        accept = testing & ~split
        credit = accept
        split_inc = do_split
        task_inc = testing
    z = torch.zeros_like(val[0])
    acc = dsk.ds_add((s.acc_h, s.acc_l), dsk.ds_where(credit, val, (z, z)))
    t = _ctz(s.i + 1)
    fin = accept & (t >= s.d)
    adv = accept & ~fin
    i_next = torch.where(do_split, s.i * 2,
                         torch.where(adv, (s.i >> t) + 1, s.i))
    d_next = torch.where(do_split, s.d + 1,
                         torch.where(adv, s.d - t, s.d))
    counters = dict(
        acc_h=acc[0], acc_l=acc[1], i=i_next, d=d_next,
        tasks=s.tasks + task_inc.to(torch.int32),
        splits=s.splits + split_inc.to(torch.int32),
        maxd=torch.maximum(s.maxd, torch.where(testing, s.base_d + s.d, 0)))
    if theta_block > 1:
        mark = do_split & credit
        counters.update(mk_i=torch.where(mark, s.i, s.mk_i),
                        mk_d=torch.where(mark, s.d, s.mk_d))
    return counters, do_split, adv, fin, ovf


def _step_trap(s: WalkState, f_ds: Callable, eps32: float,
               theta_block: int = 1) -> WalkState:
    """Trapezoid step: one eval per step through the INIT/LOAD modes."""
    parked = (s.flags & _PARKED) != 0
    mode_load = (s.flags & _MODE_LOAD) != 0
    mode_init = (s.flags & _MODE_INIT) != 0
    live = ~parked

    w, x0, x1 = _node_geometry(s)
    mid = dsk.ds_add(x0, dsk.ds_mul_pow2(w, 0.5))
    xq = dsk.ds_where(mode_load, x1, mid)
    xq = dsk.ds_where(mode_init, x0, xq)
    xq = dsk.ds_where(parked, (torch.ones_like(xq[0]),
                               torch.zeros_like(xq[1])), xq)
    fq = f_ds(xq, (s.th_h, s.th_l))

    quarter = dsk.ds_mul_pow2(w, 0.25)
    fl = (s.fl_h, s.fl_l)
    fr = (s.fr_h, s.fr_l)
    la = dsk.ds_mul(dsk.ds_add(fl, fq), quarter)
    ra = dsk.ds_mul(dsk.ds_add(fq, fr), quarter)
    val = dsk.ds_add(la, ra)
    lr = dsk.ds_mul(dsk.ds_add(fl, fr), dsk.ds_mul_pow2(w, 0.5))
    err = dsk.ds_abs(dsk.ds_sub(val, lr))
    split = (err[0] + err[1]) > eps32
    testing = live & ~(mode_load | mode_init)
    test_act = testing & ~_theta_retired(s) if theta_block > 1 else None

    upd, do_split, adv, fin, ovf = _finish_step(s, testing, split, val,
                                                theta_block, test_act)
    new_fl = dsk.ds_where(adv, fr, fl)
    new_fl = dsk.ds_where(mode_init, fq, new_fl)
    new_fr = dsk.ds_where(do_split, fq, fr)
    new_fr = dsk.ds_where(mode_load, fq, new_fr)
    flags = s.flags
    flags = torch.where(adv, flags | _MODE_LOAD, flags)
    flags = torch.where(mode_load, flags & ~_MODE_LOAD, flags)
    flags = torch.where(mode_init, (flags & ~_MODE_INIT) | _MODE_LOAD,
                        flags)
    flags = torch.where(fin, flags | _PARKED, flags)
    flags = torch.where(ovf, flags | (_PARKED | _OVF), flags)
    return s._replace(fl_h=new_fl[0], fl_l=new_fl[1], fr_h=new_fr[0],
                      fr_l=new_fr[1], flags=flags, **upd)


def _step_scout(s: WalkState, f_ds: Callable, eps32: float,
                theta_block: int = 1):
    """Scouting step: a float32 test of every live lane (endpoint loads
    fused in) and a full-ds confirm of every non-decisive decision, so
    credit never carries float32 error. In theta mode retired lanes do
    not confirm, and unretired lanes at the depth cap always do, so a
    forced accept has a ds value to credit. Returns (state, scout evals,
    confirm evals) with the counts as 0-dim int32 tensors."""
    f_scout = scout_twin(f_ds)
    parked = (s.flags & _PARKED) != 0
    mode_load = (s.flags & _MODE_LOAD) != 0
    mode_init = (s.flags & _MODE_INIT) != 0
    live = ~parked

    w, x0, x1 = _node_geometry(s)
    mid = dsk.ds_add(x0, dsk.ds_mul_pow2(w, 0.5))
    benign = (torch.ones_like(s.fl_h), torch.zeros_like(s.fl_h))
    th = (s.th_h, s.th_l)

    need_l = live & mode_init
    need_r = live & (mode_init | mode_load)
    f_m = f_scout(dsk.ds_where(parked, benign, mid), th)
    f_l = f_scout(dsk.ds_where(need_l, x0, benign), th)
    f_r = f_scout(dsk.ds_where(need_r, x1, benign), th)
    fl_eff = dsk.ds_where(mode_init, f_l, (s.fl_h, s.fl_l))
    fr_eff = dsk.ds_where(need_r, f_r, (s.fr_h, s.fr_l))

    qw = w[0]
    la32 = (fl_eff[0] + f_m[0]) * (qw * 0.25)
    ra32 = (f_m[0] + fr_eff[0]) * (qw * 0.25)
    lr32 = (fl_eff[0] + fr_eff[0]) * (qw * 0.5)
    err32 = torch.abs((la32 + ra32) - lr32)
    band = _SCOUT_BAND * (torch.abs(la32) + torch.abs(ra32)
                          + torch.abs(lr32))

    testing = live
    decisive = testing & (err32 > eps32 + band)
    if theta_block > 1:
        test_act = testing & ~_theta_retired(s)
        need_conf = test_act & (~decisive | (s.d >= MAX_REL_DEPTH))
    else:
        test_act = None
        need_conf = testing & ~decisive
    n_conf = dsk.mask_count(need_conf)
    if int(n_conf) > 0:
        g0 = f_ds(dsk.ds_where(need_conf, x0, benign), th)
        gm = f_ds(dsk.ds_where(need_conf, mid, benign), th)
        g1 = f_ds(dsk.ds_where(need_conf, x1, benign), th)
        quarter = dsk.ds_mul_pow2(w, 0.25)
        la = dsk.ds_mul(dsk.ds_add(g0, gm), quarter)
        ra = dsk.ds_mul(dsk.ds_add(gm, g1), quarter)
        val = dsk.ds_add(la, ra)
        lr = dsk.ds_mul(dsk.ds_add(g0, g1), dsk.ds_mul_pow2(w, 0.5))
        errd = dsk.ds_abs(dsk.ds_sub(val, lr))
        split_ds = (errd[0] + errd[1]) > eps32
    else:
        z32 = torch.zeros_like(s.fl_h)
        val = (z32, z32)
        split_ds = torch.zeros_like(parked)
    split = torch.where(need_conf, split_ds, decisive)

    upd, do_split, adv, fin, ovf = _finish_step(s, testing, split, val,
                                                theta_block, test_act)
    new_fl = dsk.ds_where(adv, fr_eff, fl_eff)
    new_fr = dsk.ds_where(do_split, f_m, fr_eff)
    flags = s.flags & ~(_MODE_INIT | _MODE_LOAD)
    flags = torch.where(adv, flags | _MODE_LOAD, flags)
    flags = torch.where(fin, flags | _PARKED, flags)
    flags = torch.where(ovf, flags | (_PARKED | _OVF), flags)
    sc_n = (dsk.mask_count(live) + dsk.mask_count(need_l)
            + dsk.mask_count(need_r))
    cf_n = 3 * n_conf
    s2 = s._replace(fl_h=new_fl[0], fl_l=new_fl[1], fr_h=new_fr[0],
                    fr_l=new_fr[1], flags=flags, **upd)
    return s2, sc_n, cf_n


def _step_simpson(s: WalkState, f_ds: Callable, eps32: float) -> WalkState:
    """Simpson + Richardson step: one eval per step through a 5-phase
    mode chain per node visit, INIT (f(left), fresh roots only) -> LOADM
    (f(mid)) -> LOAD (f(right)) -> TESTA (f(q1), stashed in fq) -> TESTB
    (f(q3), decide). A split hands the left child (fl, fq1, fm) for
    free; an advance reloads mid and right."""
    parked = (s.flags & _PARKED) != 0
    mode_load = (s.flags & _MODE_LOAD) != 0
    mode_init = (s.flags & _MODE_INIT) != 0
    mode_loadm = (s.flags & _MODE_LOADM) != 0
    mode_testb = (s.flags & _MODE_TESTB) != 0
    live = ~parked
    testa = live & ~(mode_load | mode_init | mode_loadm | mode_testb)

    w, x0, x1 = _node_geometry(s)
    mid = dsk.ds_add(x0, dsk.ds_mul_pow2(w, 0.5))
    q1 = dsk.ds_add(x0, dsk.ds_mul_pow2(w, 0.25))
    q3 = dsk.ds_add(mid, dsk.ds_mul_pow2(w, 0.25))
    xq = dsk.ds_where(mode_testb, q3, q1)
    xq = dsk.ds_where(mode_loadm, mid, xq)
    xq = dsk.ds_where(mode_load, x1, xq)
    xq = dsk.ds_where(mode_init, x0, xq)
    xq = dsk.ds_where(parked, (torch.ones_like(xq[0]),
                               torch.zeros_like(xq[1])), xq)
    fq = f_ds(xq, (s.th_h, s.th_l))

    fl = (s.fl_h, s.fl_l)
    fr = (s.fr_h, s.fr_l)
    fm = (s.fm_h, s.fm_l)
    fq1 = (s.fq_h, s.fq_l)
    four_fm = dsk.ds_mul_pow2(fm, 4.0)
    s1 = dsk.ds_mul(dsk.ds_mul(w, SIMPSON_SIXTH),
                    dsk.ds_add(dsk.ds_add(fl, four_fm), fr))
    inner = dsk.ds_add(
        dsk.ds_add(fl, fr),
        dsk.ds_add(dsk.ds_mul_pow2(dsk.ds_add(fq1, fq), 4.0),
                   dsk.ds_mul_pow2(fm, 2.0)))
    s2 = dsk.ds_mul(dsk.ds_mul(w, SIMPSON_TWELFTH), inner)
    diff = dsk.ds_sub(s2, s1)
    corr = dsk.ds_mul(diff, SIMPSON_FIFTEENTH)
    err = dsk.ds_abs(corr)
    val = dsk.ds_add(s2, corr)
    split = (err[0] + err[1]) > eps32
    testing = live & mode_testb

    upd, do_split, adv, fin, ovf = _finish_step(s, testing, split, val)
    new_fl = dsk.ds_where(adv, fr, fl)
    new_fl = dsk.ds_where(mode_init, fq, new_fl)
    new_fm = dsk.ds_where(do_split, fq1, fm)
    new_fm = dsk.ds_where(mode_loadm, fq, new_fm)
    new_fr = dsk.ds_where(do_split, fm, fr)
    new_fr = dsk.ds_where(mode_load, fq, new_fr)
    new_fq = dsk.ds_where(testa, fq, fq1)
    flags = s.flags
    flags = torch.where(mode_init, (flags & ~_MODE_INIT) | _MODE_LOADM,
                        flags)
    flags = torch.where(mode_loadm, (flags & ~_MODE_LOADM) | _MODE_LOAD,
                        flags)
    flags = torch.where(mode_load, flags & ~_MODE_LOAD, flags)
    flags = torch.where(testa, flags | _MODE_TESTB, flags)
    flags = torch.where(do_split, flags & ~_MODE_TESTB, flags)
    flags = torch.where(adv, (flags & ~_MODE_TESTB) | _MODE_LOADM, flags)
    flags = torch.where(fin, (flags & ~_MODE_TESTB) | _PARKED, flags)
    flags = torch.where(ovf, (flags & ~_MODE_TESTB) | (_PARKED | _OVF),
                        flags)
    return s._replace(fl_h=new_fl[0], fl_l=new_fl[1], fm_h=new_fm[0],
                      fm_l=new_fm[1], fr_h=new_fr[0], fr_l=new_fr[1],
                      fq_h=new_fq[0], fq_l=new_fq[1], flags=flags, **upd)


def _step(s: WalkState, f_ds: Callable, eps32: float, mode: int,
          theta_block: int = 1):
    """One step of step machine ``mode`` (theta groups of ``theta_block``
    lanes; Simpson has none): ``(state, scout evals, confirm evals)``,
    the counts 0-dim int32 tensors (zero outside scout mode)."""
    if mode == STEP_SCOUT:
        return _step_scout(s, f_ds, eps32, theta_block)
    zero = torch.zeros((), dtype=torch.int32, device=s.i.device)
    if mode == STEP_SIMPSON:
        if theta_block > 1:
            raise ValueError("theta_block > 1 supports Rule.TRAPEZOID only")
        return _step_simpson(s, f_ds, eps32), zero, zero
    return _step_trap(s, f_ds, eps32, theta_block), zero, zero


def _takeable(s: WalkState, slot: torch.Tensor, nslots: torch.Tensor):
    """Parked, not depth-overflowed, with a dealt root left."""
    return (((s.flags & _PARKED) != 0) & ((s.flags & _OVF) == 0)
            & (slot < nslots))


def _take(s: WalkState, slot, nslots, bank, resh, resl, resm):
    """Refill event: every takeable lane banks its finished root (result
    row slot-1, or the sentinel row at slot 0) and takes its next
    private root in INIT mode."""
    take = _takeable(s, slot, nslots)
    prev = slot - 1
    bank_m1 = take & (prev == -1)
    resm = (torch.where(bank_m1, s.acc_h, resm[0]),
            torch.where(bank_m1, s.acc_l, resm[1]),
            torch.where(bank_m1, s.fam, resm[2]))
    a_h, a_l, w_h, w_l, th_h, th_l = s.a_h, s.a_l, s.w_h, s.w_l, \
        s.th_h, s.th_l
    meta = torch.zeros_like(s.i)
    for k in range(bank[0].shape[0]):
        mk = take & (slot == k)
        a_h = torch.where(mk, bank[0][k], a_h)
        a_l = torch.where(mk, bank[1][k], a_l)
        w_h = torch.where(mk, bank[2][k], w_h)
        w_l = torch.where(mk, bank[3][k], w_l)
        th_h = torch.where(mk, bank[4][k], th_h)
        th_l = torch.where(mk, bank[5][k], th_l)
        meta = torch.where(mk, bank[6][k], meta)
        bk = take & (prev == k)
        resh[k] = torch.where(bk, s.acc_h, resh[k])
        resl[k] = torch.where(bk, s.acc_l, resl[k])
    z32 = torch.zeros_like(s.fl_h)
    zi = torch.zeros_like(s.i)

    def pick(new, old):
        return torch.where(take, new, old)

    s2 = WalkState(
        a_h=a_h, a_l=a_l, w_h=w_h, w_l=w_l, th_h=th_h, th_l=th_l,
        fl_h=pick(z32, s.fl_h), fl_l=pick(z32, s.fl_l),
        fr_h=pick(z32, s.fr_h), fr_l=pick(z32, s.fr_l),
        fm_h=pick(z32, s.fm_h), fm_l=pick(z32, s.fm_l),
        fq_h=pick(z32, s.fq_h), fq_l=pick(z32, s.fq_l),
        acc_h=pick(z32, s.acc_h), acc_l=pick(z32, s.acc_l),
        i=pick(zi, s.i), d=pick(zi, s.d),
        base_d=pick(meta & DEPTH_MASK, s.base_d),
        fam=pick(meta >> DEPTH_BITS, s.fam),
        flags=torch.where(take, _MODE_INIT, s.flags),
        tasks=s.tasks, splits=s.splits, maxd=s.maxd,
        mk_i=pick(zi, s.mk_i), mk_d=torch.where(take, -1, s.mk_d))
    return s2, torch.where(take, slot + 1, slot), resm


def segment_rf_plain(state: WalkState, slot, thresh: int, cap: int,
                     batch: int, nslots, bank, resm, *, f_ds: Callable,
                     eps: float, scout: bool, rule: Rule = Rule.TRAPEZOID,
                     theta_block: int = 1):
    """K1 in plain PyTorch: up to ``cap`` steps over all lanes. It runs
    while ``k == 0 or (k < cap and (live > thresh or nref > 0))``; each
    iteration refills first when ``nref >= batch or live <= thresh``,
    classifies every lane into the waste buckets, and takes one step.
    With ``theta_block`` = T > 1 the steps vote in groups of T lanes,
    and a live but retired lane's step counts as theta_overwalk.

    ``state``, ``slot`` and ``resm`` are updated in place. Returns
    ``(resh, resl, counters)``: this launch's (R, lanes) result banks and
    an int32 (8,) tensor [steps, 5 waste buckets, scout evals, confirm
    evals]."""
    mode = step_mode(rule, scout)
    R, lanes = bank[0].shape
    dev = slot.device
    eps32 = f32(eps)
    st, sl, rm = state, slot, tuple(resm)
    resh = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    resl = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    wa = wd = ws = wt = wo = se = ce = zero
    T = int(theta_block)

    def counts():
        live = dsk.mask_count((st.flags & _PARKED) == 0)
        nref = dsk.mask_count(_takeable(st, sl, nslots))
        return torch.stack([live, nref]).tolist()

    k = 0
    live, nref = counts()
    while k == 0 or (k < cap and (live > thresh or nref > 0)):
        if nref > 0 and (nref >= batch or live <= thresh):
            st, sl, rm = _take(st, sl, nslots, bank, resh, resl, rm)
        parked = (st.flags & _PARKED) != 0
        noroot = (st.flags & _NO_ROOT) != 0
        takeable = _takeable(st, sl, nslots)
        live_n = dsk.mask_count(~parked)
        stall_n = dsk.mask_count(takeable)
        dead_n = dsk.mask_count(noroot & ~takeable)
        over_n = (dsk.mask_count(~parked & _theta_retired(st)) if T > 1
                  else zero)
        wa = wa + live_n - over_n
        wd = wd + dead_n
        ws = ws + stall_n
        wt = wt + (lanes - live_n - stall_n - dead_n)
        wo = wo + over_n
        st, sc_n, cf_n = _step(st, f_ds, eps32, mode, T)
        se = se + sc_n
        ce = ce + cf_n
        live, nref = counts()
        k += 1
    for dst, src in zip(state, st):
        dst.copy_(src)
    slot.copy_(sl)
    for dst, src in zip(resm, rm):
        dst.copy_(src)
    counters = torch.stack([torch.full_like(zero, k), wa, wd, ws, wt,
                            wo, se, ce]).to(torch.int32)
    return resh, resl, counters


# ---------------------------------------------------------------------------
# K2 and K3 in plain PyTorch: the early-exit and fixed-length segments
# ---------------------------------------------------------------------------


def _live_count(s: WalkState) -> torch.Tensor:
    return dsk.mask_count((s.flags & _PARKED) == 0)


def segment_ee_plain(state: WalkState, thresh: int, cap: int, *,
                     f_ds: Callable, eps: float, scout: bool,
                     rule: Rule = Rule.TRAPEZOID,
                     theta_block: int = 1) -> torch.Tensor:
    """K2 in plain PyTorch: steps while ``k == 0 or (k < cap and live >
    thresh)``, ``live`` the unparked lanes after each step. Before each
    step every lane-step is counted as live (eval_active), rootless
    (masked_dead) or parked with a root. With ``theta_block`` = T > 1
    the steps vote in groups of T lanes, and a live but retired lane's
    step counts as theta_overwalk instead of eval_active (the
    reference's ``kernel_ee`` theta branch). ``state`` is updated in
    place. Returns the int32 (7,) counters [steps, eval_active,
    masked_dead, parked_with_root, theta_overwalk, scout evals, confirm
    evals]."""
    mode = step_mode(rule, scout)
    lanes = state.a_h.shape[0]
    eps32 = f32(eps)
    T = int(theta_block)
    zero = torch.zeros((), dtype=torch.int32, device=state.i.device)
    wa = wd = wr = wo = se = ce = zero
    st = state
    k, live = 0, int(_live_count(st))
    while k == 0 or (k < cap and live > thresh):
        live_n = _live_count(st)
        dead_n = dsk.mask_count((st.flags & _NO_ROOT) != 0)
        over_n = (dsk.mask_count(((st.flags & _PARKED) == 0)
                                 & _theta_retired(st)) if T > 1 else zero)
        wa = wa + live_n - over_n
        wd = wd + dead_n
        wr = wr + (lanes - live_n - dead_n)
        wo = wo + over_n
        st, sc_n, cf_n = _step(st, f_ds, eps32, mode, T)
        se = se + sc_n
        ce = ce + cf_n
        live = int(_live_count(st))
        k += 1
    for dst, src in zip(state, st):
        dst.copy_(src)
    return torch.stack([torch.full_like(zero, k), wa, wd, wr, wo, se,
                        ce]).to(torch.int32)


def _seg_mode(rule: Rule, scout: bool) -> int:
    if scout:
        raise ValueError(
            "scout mode requires the early-exit or refill kernel variants "
            "(the plain fixed-iteration kernel carries no eval counters)")
    return step_mode(rule, False)


def segment_plain(state: WalkState, iters: int, *, f_ds: Callable,
                  eps: float, rule: Rule = Rule.TRAPEZOID,
                  scout: bool = False) -> WalkState:
    """K3 in plain PyTorch: exactly ``iters`` steps over all lanes, no
    counters, ``state`` updated in place and returned. Scouting is
    refused, as by the reference."""
    mode = _seg_mode(rule, scout)
    eps32 = f32(eps)
    st = state
    for _ in range(int(iters)):
        st = _step(st, f_ds, eps32, mode)[0]
    for dst, src in zip(state, st):
        dst.copy_(src)
    return state


# ---------------------------------------------------------------------------
# The kernels on the card: csrc/walk_rf.cu (K1), walk_ee.cu (K2) and
# walk_seg.cu (K3), and their wrappers
# ---------------------------------------------------------------------------

_KERNEL_ERRORS = {
    -2: "unknown integrand family or step machine (or Simpson with "
        "theta_block > 1)",
    -3: "lanes is not a multiple of the block size, or theta_block is "
        "not a power of two dividing lanes",
    -4: "the grid cannot be co-resident on this card (cooperative launch "
        "refused; the grid is never shrunk)",
    -5: "lanes exceed the packed grid count's fields",
}

# The packed grid count of K1 and K2 (csrc/walk_grid.cuh): each block adds
# one 64-bit word of (arrivals: 16 bits, live: 24 bits, nref: 24 bits) per
# step, so a launch counts at most 2^24 - 1 lanes in at most 2^16 - 1
# blocks of 128 threads.
PACKED_ARRIVAL_BITS = 16
PACKED_COUNT_BITS = 24
PACKED_MAX_BLOCKS = (1 << PACKED_ARRIVAL_BITS) - 1
PACKED_MAX_LANES = (1 << PACKED_COUNT_BITS) - 1
KERNEL_THREADS = 128


def _kernel_family(f_ds: Callable) -> int:
    family = getattr(f_ds, "kernel_family", None)
    if family is None:
        raise ValueError(
            f"{getattr(f_ds, '__name__', f_ds)!r} has no CUDA kernel "
            f"integrand (kernel_family); registered ds twins carry one")
    return int(family)


def _device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _max_blocks(kernel: str, index: int, *variant: int) -> int:
    """Blocks of the cooperative ``kernel`` ("walk_rf" or "walk_ee")
    that card ``index`` holds at once (queried once per variant and card,
    with that card current). ``variant`` is (family, mode, theta flag)."""
    from ppls_tpu_torch.utils import cuda_build
    lib = getattr(cuda_build, f"load_{kernel}")().lib
    with torch.cuda.device(index):
        n = getattr(lib, f"{kernel}_max_coresident_blocks")(*variant)
    if n < 0:
        raise RuntimeError(f"{kernel}: the occupancy query failed")
    return n


def _check_operands(what: str, state: WalkState, device: torch.device,
                    extra=()) -> int:
    """Raise unless every operand is a contiguous tensor of its dtype and
    shape on ``device``; ``extra`` holds (name, tensor, dtype, shape)
    rows beyond the state. Returns lanes."""
    lanes = state.a_h.shape[0]
    if lanes % KERNEL_THREADS:
        raise ValueError(f"{what} needs lanes % {KERNEL_THREADS} == 0, got "
                         f"{lanes}")
    checks = [(name, t, torch.float32 if j < N_F32_FIELDS else torch.int32,
               (lanes,)) for j, (name, t) in enumerate(
                   zip(WalkState._fields, state))]
    for name, t, dtype, shape in [*checks, *extra]:
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{what} operand {name}: expected contiguous {dtype} "
                f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")
    return lanes


def _check_packed_limits(what: str, lanes: int) -> None:
    """Raise unless ``lanes`` fit the packed grid count's fields: at most
    PACKED_MAX_LANES lanes in at most PACKED_MAX_BLOCKS blocks."""
    blocks = lanes // KERNEL_THREADS
    if lanes > PACKED_MAX_LANES or blocks > PACKED_MAX_BLOCKS:
        raise ValueError(
            f"{what}: {lanes} lanes ({blocks} blocks) exceed the packed grid "
            f"count's fields (at most {PACKED_MAX_LANES} lanes in "
            f"{PACKED_MAX_BLOCKS} blocks of {KERNEL_THREADS} threads)")


def _pointer_table(operands, device: torch.device) -> torch.Tensor:
    """The operands' device addresses as a device int64 array. It goes up
    through pinned memory, so the copy is stream-ordered and does not
    wait for the stream to drain."""
    return torch.tensor([t.data_ptr() for t in operands],
                        dtype=torch.int64).pin_memory().to(
                            device, non_blocking=True)


def _launch(what: str, device: torch.device, launch) -> None:
    """Run ``launch(stream)`` with ``device`` current; raise on a
    nonzero return code."""
    index = _device_index(device)
    with torch.cuda.device(index):
        rc = launch(torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_KERNEL_ERRORS.get(rc, f'cudaError {rc}')}")


def _cpu_or_cuda(what: str, device: torch.device) -> bool:
    """True for a CPU tensor (the plain version runs), False for CUDA
    (the kernel launches); raises on anything else."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {device}")
    return False


def run_segment_rf(state: WalkState, slot, thresh: int, cap: int,
                   batch: int, nslots, bank, resm, *, f_ds: Callable,
                   eps: float, scout: bool, rule: Rule = Rule.TRAPEZOID,
                   theta_block: int = 1):
    """One K1 segment launch. On a CUDA tensor this launches the
    hand-written kernel (``csrc/walk_rf.cu``, built at first use; its
    theta variant when ``theta_block`` > 1) on the current stream, or
    raises; on a CPU tensor it runs the plain PyTorch segment
    :func:`segment_rf_plain`. Either way ``state``, ``slot`` and
    ``resm`` are updated IN PLACE, and the return value is ``(resh,
    resl, counters)`` as documented there. ``bank`` is the 7-tuple of
    (R, lanes) dealt root arrays and ``resm`` the (resm_h, resm_l,
    resm_fam) sentinel row.

    ``run_segment_rf.launches`` counts kernel launches (plain runs do
    not count)."""
    device = state.a_h.device
    T = int(theta_block)
    lanes = state.a_h.shape[0]
    if T > 1:
        validate_theta_block(T, lanes=lanes, refill_slots=bank[0].shape[0],
                             rule=rule, m=1)
    if _cpu_or_cuda("K1", device):
        return segment_rf_plain(state, slot, thresh, cap, batch, nslots,
                                bank, resm, f_ds=f_ds, eps=eps,
                                scout=scout, rule=rule, theta_block=T)
    _check_packed_limits("K1", lanes)
    family, mode = _kernel_family(f_ds), step_mode(rule, scout)
    R = bank[0].shape[0]
    bank_names = ("a_h", "a_l", "w_h", "w_l", "th_h", "th_l", "meta")
    extra = ([("slot", slot, torch.int32, (lanes,)),
              ("nslots", nslots, torch.int32, (lanes,)),
              ("resm_h", resm[0], torch.float32, (lanes,)),
              ("resm_l", resm[1], torch.float32, (lanes,)),
              ("resm_fam", resm[2], torch.int32, (lanes,))]
             + [(f"bank.{n}", t,
                 torch.int32 if n == "meta" else torch.float32, (R, lanes))
                for n, t in zip(bank_names, bank)])
    if R < 1:
        raise ValueError(f"K1 needs R >= 1, got {R}")
    _check_operands("K1", state, device, extra)
    from ppls_tpu_torch.utils.cuda_build import load_walk_rf
    lib = load_walk_rf().lib
    resh = torch.zeros((R, lanes), dtype=torch.float32, device=device)
    resl = torch.zeros((R, lanes), dtype=torch.float32, device=device)
    counters = torch.zeros(8, dtype=torch.int32, device=device)
    sync = torch.zeros(3, dtype=torch.int64, device=device)
    votes = torch.zeros(3 * (lanes // T), dtype=torch.int32, device=device)
    ptrs = _pointer_table((*state, nslots, slot, *bank, *resm, resh, resl,
                           counters, sync, votes), device)
    max_blocks = _max_blocks("walk_rf", _device_index(device), family, mode,
                             int(T > 1))
    _launch("K1", device, lambda stream: lib.walk_rf_launch(
        ptrs.data_ptr(), lanes, R, family, mode, f32(eps), int(thresh),
        int(cap), int(batch), T, max_blocks, stream))
    run_segment_rf.launches += 1
    return resh, resl, counters


run_segment_rf.launches = 0


def run_segment_ee(state: WalkState, thresh: int, cap: int, *,
                   f_ds: Callable, eps: float, scout: bool,
                   rule: Rule = Rule.TRAPEZOID, theta_block: int = 1):
    """One K2 segment launch, the reference's ``run_segment_ee``. On a
    CUDA tensor this launches the hand-written kernel
    (``csrc/walk_ee.cu``, built at first use; its theta variant when
    ``theta_block`` > 1) on the current stream, or raises; on a CPU
    tensor it runs :func:`segment_ee_plain`. ``state`` is updated IN
    PLACE. Returns ``(state, steps, (wa, wd, wr, wo), (se, ce))`` as the
    reference does, the counts as views of one int32 device tensor:
    steps, then eval_active, masked_dead, parked-with-root and
    theta_overwalk lane-steps, then scout and confirm evals.

    No entry point walks K2 with ``theta_block`` > 1: the reference
    builds that kernel (``make_walk_kernel(early_exit=True,
    theta_block=T)``) on no path, and ``validate_theta_block`` refuses
    ``refill_slots=0``. Here T must be a power of two dividing the lanes,
    with the trapezoid rule.

    ``run_segment_ee.launches`` counts kernel launches."""
    device = state.a_h.device
    T = int(theta_block)
    lanes = state.a_h.shape[0]
    if T < 1 or T & (T - 1) or lanes % T:
        raise ValueError(f"theta_block must be a power of two dividing "
                         f"lanes={lanes}, got {T}")
    if T > 1 and Rule(rule) != Rule.TRAPEZOID:
        raise ValueError("theta_block > 1 supports Rule.TRAPEZOID only")
    if _cpu_or_cuda("K2", device):
        ctr = segment_ee_plain(state, thresh, cap, f_ds=f_ds, eps=eps,
                               scout=scout, rule=rule, theta_block=T)
        return state, ctr[0], ctr[1:5], ctr[5:7]
    _check_packed_limits("K2", lanes)
    family, mode = _kernel_family(f_ds), step_mode(rule, scout)
    lanes = _check_operands("K2", state, device)
    from ppls_tpu_torch.utils.cuda_build import load_walk_ee
    lib = load_walk_ee().lib
    ctr = torch.zeros(7, dtype=torch.int32, device=device)
    sync = torch.zeros(3, dtype=torch.int64, device=device)
    # the theta groups' vote words; the T = 1 variants never read them
    votes = (torch.zeros(3 * (lanes // T), dtype=torch.int32, device=device)
             if T > 1 else sync)
    ptrs = _pointer_table((*state, ctr, sync, votes), device)
    max_blocks = _max_blocks("walk_ee", _device_index(device), family, mode,
                             int(T > 1))
    _launch("K2", device, lambda stream: lib.walk_ee_launch(
        ptrs.data_ptr(), lanes, family, mode, f32(eps), int(thresh),
        int(cap), T, max_blocks, stream))
    run_segment_ee.launches += 1
    return state, ctr[0], ctr[1:5], ctr[5:7]


run_segment_ee.launches = 0


def run_segment(state: WalkState, iters: int, *, f_ds: Callable,
                eps: float, rule: Rule = Rule.TRAPEZOID,
                scout: bool = False) -> WalkState:
    """One K3 segment launch: exactly ``iters`` steps, no counters, the
    reference's ``early_exit=False`` ``run_segment``. On a CUDA tensor
    this launches ``csrc/walk_seg.cu`` (built at first use) on the
    current stream, or raises; on a CPU tensor it runs
    :func:`segment_plain`. ``state`` is updated IN PLACE and returned.
    Scouting is refused, as by the reference.

    ``run_segment.launches`` counts kernel launches."""
    mode = _seg_mode(rule, scout)
    device = state.a_h.device
    if _cpu_or_cuda("K3", device):
        return segment_plain(state, iters, f_ds=f_ds, eps=eps, rule=rule)
    family = _kernel_family(f_ds)
    lanes = _check_operands("K3", state, device)
    from ppls_tpu_torch.utils.cuda_build import load_walk_seg
    lib = load_walk_seg().lib
    ptrs = _pointer_table(state, device)
    _launch("K3", device, lambda stream: lib.walk_seg_launch(
        ptrs.data_ptr(), lanes, family, mode, f32(eps), int(iters), stream))
    run_segment.launches += 1
    return state


run_segment.launches = 0


# ---------------------------------------------------------------------------
# Orchestration: breed, sort, deal, walk, expand, drain
# ---------------------------------------------------------------------------


def walker_sizing(lanes: int, roots_per_lane: int, capacity: int,
                  chunk: int, theta_block: int = 1):
    """``(target, breed_chunk, slack_chunk)``: the breed root target,
    the breeding pop width, and the store slack that keeps the bag's
    push windows and the expand-pending grid from ever clamping. In
    theta mode each frontier root feeds a group of T lanes, so the
    target is ``roots_per_lane * lanes / T``; the slack keeps its lane
    count."""
    target = min(roots_per_lane * (lanes // int(theta_block)),
                 capacity // 2)
    breed_chunk = max(1 << int(target - 1).bit_length(), chunk)
    slack_chunk = max(
        breed_chunk, -(-(MAX_REL_DEPTH + 1 + roots_per_lane) * lanes // 2))
    return target, breed_chunk, slack_chunk


def _breed(bag: BagState, *, f_theta, eps, chunk, capacity, target, rule,
           syncs) -> BagState:
    """BFS-refine the bag until it holds >= target roots, it empties, or
    the frontier passes its peak (count shrinks round over round)."""
    s, prev = bag, 0
    while (s.count > 0 and not s.overflow and s.iters < (1 << 20)
           and s.count < target and s.count >= prev):
        prev = s.count
        s = bag_step(s, f_theta, eps, rule, chunk, capacity, syncs)
    return s


def _breed_and_sort(bag: BagState, *, f_theta, eps, capacity, rule,
                    breed_chunk, target, syncs, breed_eps=None,
                    sort_roots: bool = True,
                    sort_skip_ratio: float = SORT_SKIP_RATIO):
    """Graduated breed (rising chunk widths bound each round's wasted
    lanes ~2x) up to ``target`` roots at ``breed_eps`` (default
    ``eps``; -1 splits every row), then, with ``sort_roots``, the work
    sort of the queue top at ``eps``. Returns ``(bred, scored_rows)``
    (0 rows scored without the sort)."""
    bkw = dict(f_theta=f_theta, eps=eps if breed_eps is None else breed_eps,
               capacity=capacity, rule=rule, syncs=syncs)
    for pc in (1 << 14, 1 << 16, 1 << 18):
        if pc < breed_chunk:
            bag = _breed(bag, chunk=pc, target=min(pc // 2, target), **bkw)
    bag = _breed(bag, chunk=breed_chunk, target=target, **bkw)
    if not sort_roots:
        return bag, 0
    return _order_roots_by_work(bag, f_theta=f_theta, eps=eps, rule=rule,
                                window=2 * breed_chunk,
                                skip_ratio=sort_skip_ratio, syncs=syncs)


def _order_roots_by_work(bag: BagState, *, f_theta, eps, rule, window,
                         skip_ratio, syncs):
    """Stable-sort the top ``window`` of the root queue ascending by the
    one-step float64 error estimate (a proxy for subtree work), in
    place. NaN keys become +inf so a NaN root stays in the live prefix
    and surfaces loudly later. With ``skip_ratio`` > 0 the sort is
    skipped when every live key is finite and within ``skip_ratio`` of
    each other (one read of the decision); 0 always sorts. Returns
    ``(bag, scored_rows)``."""
    count = bag.count
    s = max(count - window, 0)
    dev = bag.bag_l.device
    cols = [dyn_slice(c, s, window)
            for c in (bag.bag_l, bag.bag_r, bag.bag_th, bag.bag_meta)]
    l, r, th, _meta = cols
    _val, err, _split = eval_batch(l, r, lambda x: f_theta(x, th), eps,
                                   rule)
    live = torch.arange(window, device=dev) < (count - s)
    err_key = torch.where(torch.isnan(err), torch.inf, err)
    key = torch.where(live, err_key, torch.inf)
    homogeneous = False
    if skip_ratio > 0.0:
        fin = live & torch.isfinite(err_key)
        emax = torch.max(torch.where(fin, err_key, -torch.inf))
        emin = torch.min(torch.where(fin, err_key, torch.inf))
        all_fin = (live & ~fin).sum() == 0
        homogeneous = bool(syncs.pull(
            all_fin & (emax > 0)
            & (emax <= skip_ratio * torch.clamp(emin, min=1e-300))))
    if not homogeneous:
        _, order = torch.sort(key, stable=True)
        sorted_cols = [c[order] for c in cols]
        for dst, src in zip((bag.bag_l, bag.bag_r, bag.bag_th,
                             bag.bag_meta), sorted_cols):
            dyn_update(dst, src, s)
    return bag, count - s


def deal_root_bank(bag: BagState, *, refill_slots: int, lanes: int,
                   min_active: int, offset: int = 0, theta_block: int = 1,
                   theta_table: Optional[torch.Tensor] = None):
    """Deal the top ``min(count - offset, R*lanes)`` work-sorted roots
    round-robin into per-lane root banks: root p (biggest-first off the
    queue top) goes to lane p % lanes, slot p // lanes. A queue below
    ``min_active`` deals nothing. Returns ``(bank, nslots, navail,
    dealt)``: the 7-tuple of (R, lanes) bank arrays (ds limbs of left
    endpoint, width and theta, plus the meta word), the per-lane dealt
    counts, the dealt root count, and the flat (R*lanes,) dealt columns
    (l, r, th, meta).

    Theta mode (``theta_block`` = T > 1): the queue holds frontier roots
    and the top ``min(count - offset, R * lanes/T)`` go round-robin over
    the lanes/T theta groups (root p to group p % G, slot p // G), each
    replicated over its group's T lanes with lane theta
    ``theta_table[fam, lane % T]`` (float64, (m, T)) and credit id
    fam * T + lane % T in the meta word. ``navail``, ``offset`` and
    ``min_active`` count frontier roots; ``dealt`` is lane-expanded."""
    R = int(refill_slots)
    T = int(theta_block)
    G = lanes // T
    cap_roots = R * G
    dev = bag.bag_l.device
    top = bag.count - offset
    navail = min(top, cap_roots) if top >= min_active else 0

    def deal(col):
        sl_ = dyn_slice(col, max(top - cap_roots, 0), cap_roots).flip(0)
        dbl = torch.cat([sl_, sl_])
        return dyn_slice(dbl, cap_roots - navail, cap_roots)

    dl, dr, dth, dmeta = (deal(c) for c in (bag.bag_l, bag.bag_r,
                                            bag.bag_th, bag.bag_meta))
    p_ids = torch.arange(cap_roots, dtype=torch.int32, device=dev)
    dmeta = torch.where(p_ids < navail, dmeta, 0)

    if T > 1:
        def expand(col):
            return col.reshape(R, G, 1).expand(R, G, T).reshape(-1)

        dl, dr = expand(dl), expand(dr)
        fam_p = (dmeta >> DEPTH_BITS).to(torch.int64)
        dep_p = dmeta & DEPTH_MASK
        tidx = torch.arange(T, dtype=torch.int64, device=dev)
        dth = theta_table[fam_p[:, None], tidx[None, :]].reshape(-1)
        famp = fam_p[:, None].to(torch.int32) * T + tidx[None, :].to(
            torch.int32)
        dmeta = ((famp << DEPTH_BITS) + dep_p[:, None]).reshape(-1)
        p_e = torch.div(torch.arange(R * lanes, dtype=torch.int32,
                                     device=dev), T, rounding_mode="floor")
        dmeta = torch.where(p_e < navail, dmeta, 0)

    limbs = [t.reshape(R, lanes) for x in (dl, dr - dl, dth)
             for t in ds_from_f64(x)]
    bank = (*limbs, dmeta.reshape(R, lanes))
    # group g (lane l in theta mode: g = l // T) holds ceil((navail - g)
    # / G) roots
    g_ids = torch.div(torch.arange(lanes, dtype=torch.int32, device=dev), T,
                      rounding_mode="floor")
    nslots = torch.clamp(
        torch.div(navail - g_ids + G - 1, G,
                  rounding_mode="floor"), 0, R).to(torch.int32)
    return bank, nslots, navail, (dl, dr, dth, dmeta)


@dataclasses.dataclass
class _WalkOut:
    """One walk phase's result."""

    lanes: WalkState
    cursor: int               # roots dealt this phase (off the queue top)
    acc: torch.Tensor         # (m,) f64 per-family credit of the phase
    segs: int
    steps: int
    gsegs: int
    seg_stats: np.ndarray     # (S_CAP, 4) per-segment stats ring
    waste: np.ndarray         # (N_WASTE,) int64 lane-steps
    evals: np.ndarray         # (2,) int64 scout / confirm evals
    taken: int                # roots consumed this phase (frontier roots
    #                           in theta mode)
    # in-kernel refill only (None with boundary refill):
    slot: Optional[torch.Tensor] = None     # roots taken per lane
    nslots: Optional[torch.Tensor] = None   # roots dealt per lane
    dealt: Optional[tuple] = None           # flat (R*lanes,) l, r, th, meta


def _lane_summary(s: WalkState, slot, nslots):
    """(live, min slot, sum slot, takeable) as one int64 vector."""
    return torch.stack([
        ((s.flags & _PARKED) == 0).sum(), slot.min().to(torch.int64),
        slot.sum(dtype=torch.int64), _takeable(s, slot, nslots).sum()])


def _run_walk_kernel_refill(bag: BagState, *, f_ds, eps, m, seg_iters,
                            max_segments, min_active_frac, exit_frac,
                            suspend_frac, lanes, gsegs0, seg_stats0,
                            rule, refill_slots, scout, double_buffer,
                            syncs, theta_block: int = 1,
                            theta_table=None) -> _WalkOut:
    """One walk phase with in-kernel refill: deal the work-sorted queue
    into per-lane banks, launch K1 until the banks are dry and
    occupancy is at the suspension floor (or the step budget is spent),
    then credit every family with ONE exact segment sum.

    With ``double_buffer`` the R slots are two rolling half-banks: when
    every lane has consumed the active half and the queue still has
    roots, the retiring half is credited, the shadow half shifts down
    and a fresh shadow half is dealt, so one phase consumes the whole
    sorted queue.

    Theta mode (T > 1): the engagement floor counts frontier roots, the
    suspension floor is 0 (a root suspended mid-walk would lose its
    lanes' accept markers, so every engaged root runs to completion),
    taken counts are in frontier roots, and credit goes to m * T ids."""
    R = int(refill_slots)
    T = int(theta_block)
    m_eff = m * T
    dev = bag.bag_l.device
    cap_roots = R * lanes
    if T > 1:
        min_active = max(1, int((lanes // T) * min_active_frac))
        floor = 0
    else:
        min_active = int(lanes * min_active_frac)
        floor = max(min_active, int(lanes * suspend_frac))
    batch = max(lanes - int(lanes * exit_frac), 1)
    tkw = dict(theta_block=T, theta_table=theta_table)
    step_budget = max_segments * seg_iters
    top = bag.count
    f64 = torch.float64

    s = _fresh_lanes(lanes, dev)
    slot = torch.zeros(lanes, dtype=torch.int32, device=dev)
    resh = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    resl = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    resm = _fresh_sentinel(lanes, dev)
    acc_sw = torch.zeros(m_eff, dtype=f64, device=dev)
    waste = np.zeros(N_WASTE, dtype=np.int64)
    evals = np.zeros(2, dtype=np.int64)
    stats = seg_stats0
    steps = segs = taken = retired = 0
    gsegs = gsegs0

    if double_buffer:
        Rh = R // 2
        half_roots = Rh * lanes            # lane-expanded rows per half
        half_deal = Rh * (lanes // T)      # frontier roots per half
        bank_a, nsl_a, navail_a, dealt_a = deal_root_bank(
            bag, refill_slots=Rh, lanes=lanes, min_active=min_active, **tkw)
        # the first shadow half only behind a FULL active half
        gate_s = 1 if navail_a == half_deal else 1 << 30
        bank_s, nsl_s, navail_s, dealt_s = deal_root_bank(
            bag, refill_slots=Rh, lanes=lanes, min_active=gate_s,
            offset=navail_a, **tkw)
        bank = tuple(torch.cat([a, b]) for a, b in zip(bank_a, bank_s))
        nslots = nsl_a + nsl_s
        dealt = tuple(torch.cat([a, b]) for a, b in zip(dealt_a, dealt_s))
        consumed = navail_a + navail_s
    else:
        bank, nslots, consumed, dealt = deal_root_bank(
            bag, refill_slots=R, lanes=lanes, min_active=min_active, **tkw)

    live, _, _, nref = syncs.pull(_lane_summary(s, slot, nslots))
    while steps < step_budget and (live > floor or nref > 0):
        cap = min(max(step_budget - steps, 1), seg_iters)
        rh, rl, ctr = run_segment_rf(s, slot, floor, cap, batch, nslots,
                                     bank, resm, f_ds=f_ds, eps=eps,
                                     scout=scout, rule=rule, theta_block=T)
        resh += rh
        resl += rl
        summary = syncs.pull(torch.cat([ctr.to(torch.int64),
                                        _lane_summary(s, slot, nslots)]))
        waste += summary[1:1 + N_WASTE]
        evals += summary[1 + N_WASTE:3 + N_WASTE]
        si, live, min_slot, sum_slot, nref = (summary[0], *summary[8:])
        taken2 = retired + sum_slot      # lane-expanded in theta mode
        # queue left at launch: the undealt queue (rolling deal) or the
        # untaken dealt roots (single deal), as the reference records,
        # in frontier roots
        row = (si, live, top - (consumed if double_buffer else taken // T),
               (taken2 - taken) // T)
        stats[min(gsegs, S_CAP - 1)] = row
        taken = taken2
        steps += si
        segs += 1
        gsegs += 1
        if double_buffer and min_slot >= Rh and top - consumed > 0:
            # swap: credit the retiring half (every active-half root
            # was taken; a root still in flight banks through the
            # sentinel row later) plus the sentinel bankings so far
            ids = torch.cat([dealt[3][:half_roots] >> DEPTH_BITS, resm[2]])
            contrib = torch.cat([
                ds_to_f64((resh[:Rh], resl[:Rh])).reshape(-1),
                ds_to_f64(resm)])
            acc_sw = acc_sw + segment_sum_auto(ids, contrib, m_eff,
                                               half_roots + lanes)
            bank_n, nsl_n, navail_n, dealt_n = deal_root_bank(
                bag, refill_slots=Rh, lanes=lanes, min_active=1,
                offset=consumed, **tkw)
            bank = tuple(torch.cat([b[Rh:], bn])
                         for b, bn in zip(bank, bank_n))
            nslots = (nslots - Rh) + nsl_n
            dealt = tuple(torch.cat([d[half_roots:], dn])
                          for d, dn in zip(dealt, dealt_n))
            slot -= Rh
            resh = torch.cat([resh[Rh:], torch.zeros_like(resh[:Rh])])
            resl = torch.cat([resl[Rh:], torch.zeros_like(resl[:Rh])])
            for t in resm:
                t.zero_()
            consumed += navail_n
            retired += half_roots
            live, _, _, nref = syncs.pull(_lane_summary(s, slot, nslots))

    acc0 = acc_sw
    if double_buffer:
        # the last uncredited sentinel bankings
        acc0 = acc_sw + segment_sum_auto(resm[2], ds_to_f64(resm), m_eff,
                                         lanes)

    # phase-end credit: completed roots from the result bank (ids from
    # the dealt meta) + every lane's in-flight accumulator
    has_root = (s.flags & _NO_ROOT) == 0
    lane_contrib = torch.where(has_root, ds_to_f64((s.acc_h, s.acc_l)),
                               0.0)
    grid_contrib = ds_to_f64((resh, resl)).reshape(-1)
    ids = torch.cat([s.fam, dealt[3] >> DEPTH_BITS])
    contrib = torch.cat([lane_contrib, grid_contrib])
    acc = acc0 + segment_sum_auto(ids, contrib, m_eff, lanes + cap_roots)
    return _WalkOut(lanes=s, cursor=consumed, acc=acc, segs=segs,
                    steps=steps, gsegs=gsegs, seg_stats=stats, waste=waste,
                    evals=evals, slot=slot, nslots=nslots, dealt=dealt,
                    taken=taken // T)


def _bank_and_refill(s: WalkState, acc: torch.Tensor, bag: BagState,
                     cursor: int, m: int):
    """The boundary of a boundary-refill walk (the reference's
    ``_bank_and_refill``): credit every finished lane's accumulator to
    its family, then permute the lanes so the refillable ones (parked,
    not OVF) form a prefix in lane order, and hand the first
    ``n_taken = min(n_ref, avail)`` of them roots p = 0, 1, ... off the
    queue top, bag[top - 1 - p], in INIT mode; the other refillable
    lanes retire to parked | no-root. OVF lanes keep their state (their
    pending nodes feed the mop-up) and are not refilled. Root endpoint
    values are left to the kernel's INIT/LOAD steps.

    Returns ``(state, acc, n_taken)``, ``n_taken`` a 0-dim device
    tensor (the cursor advance), so the boundary reads nothing back."""
    lanes = s.i.shape[0]
    dev = s.i.device
    parked = (s.flags & _PARKED) != 0
    has_root = (s.flags & _NO_ROOT) == 0
    ovf = (s.flags & _OVF) != 0
    contrib = torch.where(parked & has_root,
                          ds_to_f64((s.acc_h, s.acc_l)), 0.0)
    acc = acc + segment_sum_auto(s.fam, contrib, m, lanes)

    # The reference stable-sorts all 26 columns keyed by refill rank (or
    # `lanes`): a partition, refillable lanes first in lane order, then
    # the rest in lane order. Two cumsums give each lane its place. (The
    # reference's optimization_barrier on the key guards an XLA
    # miscompile; eager PyTorch has nothing to guard.)
    ref32 = (parked & ~ovf).to(torch.int32)
    n_ref = ref32.sum(dtype=torch.int32)
    rank = torch.cumsum(ref32, 0, dtype=torch.int32) - 1
    rest = torch.cumsum(1 - ref32, 0, dtype=torch.int32) - 1
    dest = torch.where(ref32 != 0, rank, n_ref + rest).to(torch.int64)
    pos = torch.arange(lanes, device=dev)
    order = torch.empty_like(pos)
    order[dest] = pos
    f_cols = torch.stack(s[:N_F32_FIELDS])[:, order]
    i_cols = torch.stack(s[N_F32_FIELDS:])[:, order]
    sp = WalkState(*f_cols.unbind(), *i_cols.unbind())

    # roots consumed from the TOP, so the remainder [0, count - cursor)
    # stays a valid bag prefix; root p sits at bag[top - 1 - p]. Rows
    # p >= n_taken are masked below, so their (clamped) index is benign.
    avail = bag.count - cursor
    idx = torch.clamp(avail - 1 - pos, min=0)
    rl, rr, rth, rmeta = (c[idx] for c in (bag.bag_l, bag.bag_r,
                                           bag.bag_th, bag.bag_meta))
    a_h, a_l = ds_from_f64(rl)
    w_h, w_l = ds_from_f64(rr - rl)
    th_h, th_l = ds_from_f64(rth)
    n_taken = torch.clamp(n_ref, max=avail)
    take = pos < n_taken
    retire = (pos >= n_taken) & (pos < n_ref)
    z32 = torch.zeros(lanes, dtype=torch.float32, device=dev)
    zi = torch.zeros(lanes, dtype=torch.int32, device=dev)

    def pick(new, old):
        return torch.where(take, new, old)

    # banked lanes' accumulators reset; finished lanes that got no root
    # go idle; OVF lanes keep their flags and state
    banked = ((sp.flags & _PARKED) != 0) & ((sp.flags & _NO_ROOT) == 0)
    flags = torch.where(take, _MODE_INIT, sp.flags)
    flags = torch.where(retire, _PARKED | _NO_ROOT, flags)
    out = WalkState(
        a_h=pick(a_h, sp.a_h), a_l=pick(a_l, sp.a_l),
        w_h=pick(w_h, sp.w_h), w_l=pick(w_l, sp.w_l),
        th_h=pick(th_h, sp.th_h), th_l=pick(th_l, sp.th_l),
        fl_h=pick(z32, sp.fl_h), fl_l=pick(z32, sp.fl_l),
        fr_h=pick(z32, sp.fr_h), fr_l=pick(z32, sp.fr_l),
        fm_h=pick(z32, sp.fm_h), fm_l=pick(z32, sp.fm_l),
        fq_h=pick(z32, sp.fq_h), fq_l=pick(z32, sp.fq_l),
        acc_h=torch.where(banked, z32, sp.acc_h),
        acc_l=torch.where(banked, z32, sp.acc_l),
        i=pick(zi, sp.i), d=pick(zi, sp.d),
        base_d=pick(rmeta & DEPTH_MASK, sp.base_d),
        fam=pick(rmeta >> DEPTH_BITS, sp.fam),
        flags=flags, tasks=sp.tasks, splits=sp.splits, maxd=sp.maxd,
        mk_i=pick(zi, sp.mk_i),
        mk_d=torch.where(take, -1, sp.mk_d))
    return out, acc, n_taken


def _run_walk(bag: BagState, *, f_ds, eps, m, seg_iters, max_segments,
              min_active_frac, exit_frac, suspend_frac, lanes, gsegs0,
              seg_stats0, rule, scout, syncs) -> _WalkOut:
    """One boundary-refill walk phase (the reference's ``_run_walk``):
    seed every lane off the queue top, then launch K2 until occupancy
    falls to ``exit_frac * lanes``, bank and refill at the boundary, and
    repeat. Once the queue is dry the threshold drops to the suspension
    floor and the phase ends there (the survivors' pending nodes go back
    to the bag), or when the step budget is spent. Each segment reads
    its counters, the live count and the cursor advance back in one
    host sync."""
    dev = bag.bag_l.device
    min_active = int(lanes * min_active_frac)
    exit_thresh = int(lanes * exit_frac)
    dry_thresh = max(min_active, int(lanes * suspend_frac))
    step_budget = max_segments * seg_iters
    waste = np.zeros(N_WASTE, dtype=np.int64)
    evals = np.zeros(2, dtype=np.int64)
    stats = seg_stats0
    steps = segs = 0
    gsegs = gsegs0

    s, acc, n_taken = _bank_and_refill(
        _fresh_lanes(lanes, dev), torch.zeros(m, dtype=torch.float64,
                                              device=dev), bag, 0, m)
    cursor, active = syncs.pull(torch.stack([n_taken.to(torch.int64),
                                             _live_count(s).to(
                                                 torch.int64)]))
    while steps < step_budget:
        queue_left = bag.count - cursor
        floor = min_active if queue_left > 0 else dry_thresh
        if not (active >= floor or (queue_left > 0 and active + queue_left
                                    >= min_active)):
            break
        thresh = exit_thresh if queue_left > 0 else dry_thresh
        cap = min(max(step_budget - steps, 1), seg_iters)
        s, si, w4, e2 = run_segment_ee(s, thresh, cap, f_ds=f_ds, eps=eps,
                                       scout=scout, rule=rule)
        live_exit = _live_count(s)
        s, acc, n_taken = _bank_and_refill(s, acc, bag, cursor, m)
        row = syncs.pull(torch.cat([
            si.reshape(1), w4, e2,
            torch.stack([live_exit, n_taken, _live_count(s)])]).to(
                torch.int64))
        si, wa, wd, wr, wo, se, ce, live_exit, n_taken, active = row
        stats[min(gsegs, S_CAP - 1)] = (si, live_exit, queue_left, n_taken)
        # the kernel counts parked-with-root lane-steps as one number;
        # the queue at launch names the cause: roots were waiting for
        # this boundary (refill_stall), or none were left (drain_tail)
        dry = queue_left <= 0
        waste += (wa, wd, 0 if dry else wr, wr if dry else 0, wo)
        evals += (se, ce)
        steps += si
        segs += 1
        gsegs += 1
        cursor += n_taken

    # final credit: lanes suspended mid-walk hold accepted-leaf sums no
    # boundary banked; their pending nodes become mop-up tasks
    suspended = ((s.flags & _NO_ROOT) == 0) & ((s.flags & _PARKED) == 0)
    contrib = torch.where(suspended, ds_to_f64((s.acc_h, s.acc_l)), 0.0)
    acc = acc + segment_sum_auto(s.fam, contrib, m, lanes)
    return _WalkOut(lanes=s, cursor=cursor, acc=acc, segs=segs, steps=steps,
                    gsegs=gsegs, seg_stats=stats, waste=waste, evals=evals,
                    taken=cursor)


def _expand_pending(walk: _WalkOut, bag: BagState, capacity: int, m: int,
                    syncs: HostSyncs, theta_block: int = 1) -> BagState:
    """Convert un-walked state back into explicit bag tasks, in place.

    Roots were dealt off the TOP of the bag, so the never-dealt
    remainder [0, count - cursor) is already a valid bag prefix. The
    suspended lanes' pending sets (the current node (i, d) plus the right
    sibling (i >> k) + 1 at depth d - k for every zero bit k < d) and,
    after an in-kernel-refill phase, the dealt roots a lane never
    reached are compacted with one stable sort and pushed on top of
    it.

    Theta mode (T > 1; ``m`` is then m * T): pending nodes and untaken
    dealt roots come from the group leaders (lane % T == 0) only and go
    back as frontier rows (family fam // T, the leader's theta). A
    suspended theta lane means the step budget ran out mid-root, whose
    retired lanes' markers would be lost: it sets ``overflow``."""
    s = walk.lanes
    dev = s.i.device
    T = int(theta_block)
    has_root = (s.flags & _NO_ROOT) == 0
    parked = (s.flags & _PARKED) != 0
    ovf = (s.flags & _OVF) != 0
    suspended = (has_root & ~parked) | ovf
    theta_suspended = suspended.any()
    if T > 1:
        leader = torch.arange(s.i.shape[0], device=dev) % T == 0
        suspended = suspended & leader

    f64 = torch.float64
    a64 = ds_to_f64((s.a_h, s.a_l))
    w64 = ds_to_f64((s.w_h, s.w_l))
    th = ds_to_f64((s.th_h, s.th_l))

    ks = torch.arange(MAX_REL_DEPTH + 1, dtype=torch.int32,
                      device=dev)[:, None]
    kb = torch.clamp(ks - 1, min=0)
    i_l, d_l = s.i[None, :], s.d[None, :]
    node_i = torch.where(ks == 0, i_l, (i_l >> kb) + 1)
    node_d = torch.where(ks == 0, d_l, d_l - kb)
    valid = torch.where(
        ks == 0, suspended[None, :],
        suspended[None, :] & (kb < d_l) & (((i_l >> kb) & 1) == 0))
    wd = w64[None, :] * pow2_f64(-node_d)
    ln = a64[None, :] + node_i.to(f64) * wd
    rn = ln + wd
    fam_l = torch.div(s.fam, T, rounding_mode="floor")
    meta_n = ((fam_l[None, :] << DEPTH_BITS)
              + torch.clamp(s.base_d[None, :] + node_d, max=DEPTH_MASK))
    th_n = th[None, :].expand_as(ln)

    if walk.dealt is not None:
        # dealt roots a lane never reached (slot <= k < nslots) re-enter
        lanes = s.i.shape[0]
        Rk = walk.dealt[3].shape[0] // lanes
        kk = torch.arange(Rk, dtype=torch.int32, device=dev)[:, None]
        valid_u = (kk >= walk.slot[None, :]) & (kk < walk.nslots[None, :])
        dealt_meta = walk.dealt[3].reshape(Rk, lanes)
        if T > 1:
            valid_u = valid_u & leader[None, :]
            dealt_meta = ((torch.div(dealt_meta >> DEPTH_BITS, T,
                                     rounding_mode="floor") << DEPTH_BITS)
                          + (dealt_meta & DEPTH_MASK))
        ln = torch.cat([ln, walk.dealt[0].reshape(Rk, lanes)])
        rn = torch.cat([rn, walk.dealt[1].reshape(Rk, lanes)])
        th_n = torch.cat([th_n, walk.dealt[2].reshape(Rk, lanes)])
        meta_n = torch.cat([meta_n, dealt_meta])
        valid = torch.cat([valid, valid_u])

    key = (~valid).reshape(-1).to(torch.int32)
    _, order = torch.sort(key, stable=True)
    sl, sr, sth, smeta = (x.reshape(-1)[order]
                          for x in (ln, rn, th_n, meta_n))
    n_pend, any_suspended = syncs.pull(torch.stack([
        valid.sum(), theta_suspended.to(torch.int64)]))
    remain = bag.count - walk.cursor
    live_row = torch.arange(sl.shape[0], device=dev) < n_pend
    sl = torch.where(live_row, sl, sl[0])
    sr = torch.where(live_row, sr, sr[0])
    sth = torch.where(live_row, sth, sth[0])
    smeta = torch.where(live_row, smeta, 0)
    dyn_update(bag.bag_l, sl, remain)
    dyn_update(bag.bag_r, sr, remain)
    dyn_update(bag.bag_th, sth, remain)
    dyn_update(bag.bag_meta, smeta, remain)
    n_tasks = remain + n_pend
    return BagState(
        bag_l=bag.bag_l, bag_r=bag.bag_r, bag_th=bag.bag_th,
        bag_meta=bag.bag_meta, count=min(n_tasks, capacity),
        acc=torch.zeros(m, dtype=f64, device=dev),
        max_depth=torch.zeros((), dtype=torch.int32, device=dev),
        overflow=n_tasks > capacity or (T > 1 and bool(any_suspended)))


def _theta_bag_round(state: BagState, theta_table: torch.Tensor,
                     theta_block: int, f_theta: Callable, eps: float,
                     chunk: int, capacity: int,
                     syncs: HostSyncs) -> BagState:
    """One union-refinement float64 bag round, theta mode's
    :func:`bag_step`: each popped frontier row tests its 3 trapezoid
    nodes against all T thetas of its slot (``theta_table[fam]``),
    splits when any theta fails its own test, and on acceptance credits
    every theta its own value at id fam * T + t (exact segment sum).
    Pushed rows stay theta-less frontier tasks. Tasks count n_take * T
    and splits the per-theta failures."""
    T = int(theta_block)
    m_eff = state.acc.shape[0]
    n_take = min(state.count, chunk)
    start = state.count - n_take
    dev = state.bag_l.device
    l = dyn_slice(state.bag_l, start, chunk)
    r = dyn_slice(state.bag_r, start, chunk)
    th = dyn_slice(state.bag_th, start, chunk)
    meta = dyn_slice(state.bag_meta, start, chunk)
    active = torch.arange(chunk, dtype=torch.int32, device=dev) < n_take

    fam = meta >> DEPTH_BITS
    depth = meta & DEPTH_MASK
    th2 = theta_table[torch.clamp(fam, 0, theta_table.shape[0] - 1).to(
        torch.int64)]                                      # (chunk, T)
    mid = (l + r) * 0.5
    fl = f_theta(l[:, None], th2)
    fr = f_theta(r[:, None], th2)
    fm = f_theta(mid[:, None], th2)
    lrarea = (fl + fr) * ((r - l) * 0.5)[:, None]
    larea = (fl + fm) * ((mid - l) * 0.5)[:, None]
    rarea = (fm + fr) * ((r - mid) * 0.5)[:, None]
    value = larea + rarea
    err = torch.abs(value - lrarea)
    split_t = err > eps
    split = split_t.any(dim=1) & active
    accept = active & ~split

    leaf = torch.where(accept[:, None], value, 0.0)
    tids = fam[:, None] * T + torch.arange(T, dtype=torch.int32,
                                           device=dev)[None, :]
    acc = state.acc + segment_sum_auto(tids.reshape(-1), leaf.reshape(-1),
                                       m_eff, chunk * T)
    max_depth = torch.maximum(
        state.max_depth,
        torch.max(torch.where(active, depth, 0)).to(torch.int32))

    # children: bag_step's compaction and two child windows
    skey = torch.where(split, meta, meta | ACCEPT_BIT)
    skey, order = torch.sort(skey, stable=True)
    sl, sr, sth = l[order], r[order], th[order]
    smid = (sl + sr) * 0.5
    ch_meta = (skey & ~ACCEPT_BIT) + 1
    n_split, n_split_t = syncs.pull(torch.stack([
        split.sum(dtype=torch.int64),
        (split_t & active[:, None]).sum(dtype=torch.int64)]))
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
        tasks=state.tasks + n_take * T, splits=state.splits + n_split_t,
        iters=state.iters + 1, max_depth=max_depth,
        overflow=state.overflow or new_count_raw > capacity)


def _run_theta_bag(state: BagState, *, theta_table, theta_block: int,
                   f_theta: Callable, eps: float, chunk: int,
                   capacity: int, max_iters: int, syncs: HostSyncs,
                   stop_count: Optional[int] = None) -> BagState:
    """Union-refinement rounds (theta mode's :func:`run_bag`) to empty,
    to ``stop_count`` tasks, or ``max_iters`` rounds."""
    while (state.count > 0 and not state.overflow
           and state.iters < max_iters
           and (stop_count is None or state.count < stop_count)):
        state = _theta_bag_round(state, theta_table, theta_block, f_theta,
                                 eps, chunk, capacity, syncs)
    return state


@dataclasses.dataclass
class _CycleOut:
    bred: BagState            # post-breed/sort queue (acc = breed credit)
    walk: _WalkOut            # walk phase (acc = walker credit)
    bag3: BagState            # post-expand/drain bag (acc = drain credit)
    bag2_count: int           # remainder count before the drain gate
    srows: int                # live rows err-scored by the root sort


def _cycle_once(bag: BagState, *, f_theta, f_ds, eps, m, seg_iters,
                max_segments, min_active_frac, exit_frac, suspend_frac,
                lanes, capacity, breed_chunk, target, rule, refill_slots,
                gsegs0, seg_stats0, scout, double_buffer, syncs,
                theta_block: int = 1, theta_table=None,
                sort_roots: bool = True,
                sort_skip_ratio: float = SORT_SKIP_RATIO) -> _CycleOut:
    """One engine cycle: graduated breed -> work sort (``sort_roots``) ->
    walk (in-kernel
    refill when ``refill_slots`` > 0, boundary refill otherwise) ->
    expand -> drain (only below the walker's engagement floor, and only
    until the frontier regrows past the root target).

    Theta mode (T > 1): the bag holds theta-less frontier rows; breeding
    only splits (eps -1, the target clamped to one deal: a breed accept
    scored on the representative theta could strand another theta above
    its eps), the walk runs the union vote, and the drain is the
    union-refinement float64 round with its pop width clamped
    (:func:`theta_drain_chunk`); ``m`` stays the slot count."""
    T = int(theta_block)
    if T > 1:
        target = theta_breed_target(target, refill_slots, lanes, T)
    bred, srows = _breed_and_sort(
        bag, f_theta=f_theta, eps=eps, capacity=capacity, rule=rule,
        breed_chunk=breed_chunk, target=target, syncs=syncs,
        breed_eps=-1.0 if T > 1 else eps, sort_roots=sort_roots,
        sort_skip_ratio=sort_skip_ratio)
    wkw = dict(f_ds=f_ds, eps=eps, m=m, seg_iters=seg_iters,
               max_segments=max_segments, min_active_frac=min_active_frac,
               exit_frac=exit_frac, suspend_frac=suspend_frac, lanes=lanes,
               gsegs0=gsegs0, seg_stats0=seg_stats0, rule=rule, scout=scout,
               syncs=syncs)
    if refill_slots:
        walk = _run_walk_kernel_refill(bred, refill_slots=refill_slots,
                                       double_buffer=double_buffer,
                                       theta_block=T,
                                       theta_table=theta_table, **wkw)
    else:
        walk = _run_walk(bred, **wkw)
    bag2 = _expand_pending(walk, bred, capacity, m * T, syncs, T)
    bag3 = bag2
    if bag2.count < max(1, int((lanes // T) * min_active_frac)):
        dkw = dict(f_theta=f_theta, eps=eps, capacity=capacity,
                   max_iters=1 << 20, syncs=syncs, stop_count=target)
        if T > 1:
            bag3 = _run_theta_bag(bag2, theta_table=theta_table,
                                  theta_block=T,
                                  chunk=theta_drain_chunk(breed_chunk, T),
                                  **dkw)
        else:
            bag3 = run_bag(bag2, rule=rule, chunk=breed_chunk, **dkw)
    return _CycleOut(bred=bred, walk=walk, bag3=bag3,
                     bag2_count=bag2.count, srows=srows)


@dataclasses.dataclass
class WalkerResult:
    areas: np.ndarray
    metrics: RunMetrics
    lane_efficiency: float       # walker tasks / (kernel steps * lanes)
    walker_fraction: float       # share of tasks done by the walk kernel
    cycles: int = 0
    seg_stats: Optional[np.ndarray] = None    # SEG_STAT_FIELDS rows
    cycle_stats: Optional[np.ndarray] = None  # CYCLE_STAT_FIELDS rows
    lanes: int = 0
    kernel_steps: int = 0
    refill_slots: int = 0
    waste: Optional[np.ndarray] = None        # (N_WASTE,) lane-steps
    scout_evals: int = 0
    confirm_evals: int = 0
    evals_estimated: bool = False             # a legacy snapshot's share
    host_syncs: int = 0                       # device reads by the host
    host_syncs_per_cycle: Optional[list] = None
    device: str = ""
    failed: Optional[np.ndarray] = None       # nan_policy="quarantine"
    # the engines across devices only (sharded_walker.py):
    collective_rounds: int = 0                # breed rounds + phase reshards
    waste_per_chip: Optional[np.ndarray] = None   # (n, N_WASTE)
    mesh: Optional[dict] = None               # transport, calls, launches

    @property
    def collective_rounds_per_cycle(self) -> float:
        """Collective boundaries per engine cycle, the refill mode's
        acceptance number across devices (strictly below legacy's)."""
        return self.collective_rounds / self.cycles if self.cycles else 0.0

    def attribution(self) -> Optional[dict]:
        """Where every kernel lane-step went. ``reconciles``: the
        buckets sum to lanes x kernel steps."""
        if self.waste is None:
            return None
        buckets = {k: int(v) for k, v in zip(WASTE_FIELDS, self.waste)}
        lane_steps = int(self.kernel_steps) * int(self.lanes)
        waste_only = {k: v for k, v in buckets.items()
                      if k != "eval_active"}
        return {
            "buckets": buckets,
            "lane_steps": lane_steps,
            "reconciles": sum(buckets.values()) == lane_steps,
            # None when no lane-step was wasted (the reference's rule)
            "dominant_waste": (max(waste_only, key=waste_only.get)
                               if any(waste_only.values()) else None),
        }

    def occupancy_summary(self) -> Optional[dict]:
        """Per-run occupancy breakdown from the stats rows, as the
        reference computes it. ``est_occupancy`` is the steps-weighted
        mean of each segment's (live at start + live at exit) / 2, live at
        start rebuilt as the previous segment's exit count plus that
        boundary's refills: valid for boundary refill only. In-kernel
        refill rows count a whole launch's takes, so there it is None
        (``lane_efficiency`` is that mode's occupancy number)."""
        ss = self.seg_stats
        if ss is None or len(ss) == 0 or not self.lanes:
            return None
        ss = np.asarray(ss, dtype=np.float64)
        steps, live_exit, queue_left, refilled = ss.T
        lanes = float(self.lanes)
        tot = steps.sum()
        dry = queue_left <= 0
        est_occ = None
        if not self.refill_slots:
            # row i's `refilled` is the boundary after segment i, so
            # segment i+1 starts with live_exit[i] + refilled[i] lanes
            live_start = np.empty_like(live_exit)
            live_start[0] = lanes        # the seeding fills every lane
            live_start[1:] = np.minimum(lanes,
                                        live_exit[:-1] + refilled[:-1])
            occ = (live_start + live_exit) / (2 * lanes)
            w = steps / tot if tot else steps
            est_occ = round(float((occ * w).sum()), 4)
        out = {
            "mode": ("in-kernel-refill" if self.refill_slots
                     else "boundary-refill"),
            "segments": int(len(ss)),
            "kernel_steps": int(tot),
            "mean_steps_per_segment": round(float(steps.mean()), 1),
            "est_occupancy": est_occ,
            "dry_queue_steps_frac": round(
                float(steps[dry].sum() / tot) if tot else 0.0, 4),
            "refilled_roots": int(refilled.sum()),
        }
        cs = self.cycle_stats
        if cs is not None and len(cs):
            cs = np.asarray(cs, dtype=np.float64)
            wt = cs[:, CYCLE_STAT_FIELDS.index("walker_tasks")].sum()
            dt = cs[:, CYCLE_STAT_FIELDS.index("drain_tasks")].sum()
            out["drain_tasks_frac"] = round(
                float(dt / max(wt + dt, 1.0)), 4)
            out["cycles_recorded"] = int(len(cs))
        return out


def derive_kernel_evals(sevals: int, cevals: int, eval_active: int,
                        wtasks: int, wsplits: int, roots: int,
                        rule: Rule, est_kevals: int = 0):
    """The one derivation of the walk kernels' integrand-eval count,
    shared by the single and dd results so the two cannot drift: the
    device-counted scout + confirm evals in scout mode, the eval_active
    waste bucket otherwise (each live lane-step evaluates one real
    point), plus ``est_kevals``, the host model's estimate of a legacy
    snapshot's share. With no counter anywhere and walker tasks, the
    whole run takes the host model. Returns ``(kernel_evals,
    evals_estimated)``: estimated whenever a model share is mixed in."""
    counted = (sevals + cevals) if sevals else int(eval_active)
    estimated = est_kevals > 0
    if counted == 0 and wtasks > 0 and not estimated:
        est_kevals = _host_model_kevals(wtasks, wsplits, roots, rule)
        estimated = True
    return counted + int(est_kevals), estimated


def _host_model_kevals(wtasks: int, wsplits: int, roots: int,
                       rule: Rule) -> int:
    """The reference's host model of the kernels' evals, from walker
    tasks, splits and roots (what predates the device counters)."""
    return (2 * wtasks - wsplits + roots
            if Rule(rule) == Rule.TRAPEZOID else
            4 * wtasks - 2 * wsplits + roots)


def estimate_legacy_kernel_evals(totals: dict, rule: Rule) -> int:
    """The host-model kernel evals of a restored snapshot whose totals
    predate the device counters (no waste buckets, no scout counts, but
    walker tasks): the pre-resume share, estimated where it is still
    separable from the legs the resumed run adds. 0 otherwise."""
    waste = totals.get("waste") or [0] * 4
    wtasks = int(totals.get("wtasks", 0))
    if any(int(v) for v in np.asarray(waste).reshape(-1)) \
            or int(totals.get("sevals", 0)) or wtasks == 0:
        return 0
    return _host_model_kevals(wtasks, int(totals.get("wsplits", 0)),
                              int(totals.get("roots", 0)), rule)


def _walker_identity(f_theta, f_ds, eps, theta2d, bounds, rule, scout,
                     double_buffer, theta_block) -> dict:
    """The walker's snapshot identity, the reference's keys: the problem,
    plus the schedule modes (scouting, double-buffered banks, the
    reduced twin, theta_block > 1) as conditional keys."""
    identity = _family_ckpt_identity(engine_name("walker", rule), f_theta,
                                     eps, theta2d.shape[0], theta2d, bounds)
    if scout:
        identity["scout"] = True
    if double_buffer:
        identity["double_buffer"] = True
    if _is_reduced_twin(f_ds):
        identity["reduced"] = True
    if int(theta_block) > 1:
        identity["theta_block"] = int(theta_block)
    return identity


def seed_family_walker_state(theta, bounds, *, chunk: int = 1 << 15,
                             capacity: int = 1 << 23,
                             lanes: int = DEFAULT_LANES,
                             roots_per_lane: int = 12,
                             theta_block: int = 1,
                             device="cuda") -> BagState:
    """Build the walker's initial seed bag once, on ``device``, for
    reuse across repeated runs of the same problem (pass it as
    ``_state_override=`` to :func:`dispatch_family_walker`). The seed is
    pure input: each run walks its own copy, so one seed backs any
    number of dispatches, each equal to a fresh run."""
    dev = resolve_device(device)
    theta2d, rep_theta = normalize_theta_batch(theta, theta_block)
    rep_theta, bounds = _family_problem(rep_theta, bounds)
    _, _, slack_chunk = walker_sizing(lanes, roots_per_lane, capacity,
                                      chunk, theta_block)
    return initial_bag(bounds, capacity, theta2d.shape[0] * int(theta_block),
                       slack_chunk, theta=rep_theta, device=dev)


def _copy_bag(bag: BagState) -> BagState:
    """A bag on fresh storage (the cycle updates its store in place)."""
    return dataclasses.replace(
        bag, bag_l=bag.bag_l.clone(), bag_r=bag.bag_r.clone(),
        bag_th=bag.bag_th.clone(), bag_meta=bag.bag_meta.clone(),
        acc=bag.acc.clone(), max_depth=bag.max_depth.clone())


class WalkerDispatch(NamedTuple):
    """A walker run queued by :func:`dispatch_family_walker`; redeem it
    with :func:`collect_family_walker`.

    The port's cycle loop reads device values on the host inside every
    cycle, so a queued run cannot run ahead of the host as the
    reference's asynchronous dispatch does: ``run`` holds the validated
    run, and the collect walks it. ``t0`` is the dispatch time, so, as
    in the reference, a queued run's ``wall_time_s`` spans every run
    collected before it; the deltas between consecutive collects are the
    per-run walls."""

    run: Callable
    t0: float
    lanes: int
    rule: Rule = Rule.TRAPEZOID
    refill_slots: int = 0
    theta_block: int = 1
    nan_policy: str = "raise"
    checkpoint_path: Optional[str] = None


@dataclasses.dataclass
class _RunOut:
    """What a finished cycle loop hands :func:`collect_family_walker`."""
    areas: np.ndarray
    tot: dict
    waste: np.ndarray
    evals: np.ndarray
    cycles: int
    est_kevals: int
    left: int
    overflow: bool
    seg_stats: np.ndarray
    cyc_rows: list
    host_syncs: int
    syncs_per_cycle: list
    device: str


def integrate_family_walker(
        f_theta: Callable, f_ds: Callable, theta: Sequence[float],
        bounds, eps: float,
        chunk: int = 1 << 15,
        capacity: int = 1 << 23,
        lanes: int = DEFAULT_LANES,
        roots_per_lane: int = 12,
        seg_iters: int = 2048,
        max_segments: int = 1 << 18,
        min_active_frac: float = 0.1,
        exit_frac: Optional[float] = None,
        suspend_frac: Optional[float] = None,
        max_cycles: int = 64,
        rule: Rule = Rule.TRAPEZOID,
        sort_roots: bool = True,
        refill_slots: int = 0,
        sort_skip_ratio: float = SORT_SKIP_RATIO,
        scout_dtype: Optional[str] = None,
        double_buffer: bool = False,
        theta_block: int = 1,
        nan_policy: str = "raise",
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
        device="cuda",
        _state_override: Optional[BagState] = None,
        _totals_override: Optional[dict] = None,
        _crash_after_legs: Optional[int] = None,
        _dispatch_only: bool = False) -> WalkerResult:
    """Flagship integration of the family ``f_theta(x, theta_i)`` over
    ``bounds``: cycles of breed -> sort -> deal -> walk -> expand ->
    drain. ``f_ds`` is the family's ds twin (``get_family_ds``); on CUDA
    its ``kernel_family`` selects the integrand compiled into K1.

    The reference entry point's parameters and defaults, plus ``device``
    (CUDA by default; raises without a card unless ``device="cpu"`` is
    passed, which runs the plain PyTorch segments). ``refill_slots`` = 0
    walks with boundary refill (K2), R > 0 with in-kernel refill (K1).
    Unless ``exit_frac``/``suspend_frac`` are given, a registered family
    resolves its cadence through the tuning table's rows for this
    device (``resolve_cadence``). ``sort_roots=False`` walks the bred
    queue unsorted; ``sort_skip_ratio`` skips the sort when the queue's
    errors lie within that ratio (0 always sorts). ``nan_policy=
    "quarantine"`` reports non-finite families in ``failed`` instead of
    raising ``FloatingPointError``.

    ``theta_block`` = T > 1 (in-kernel refill, trapezoid rule) takes
    ``theta`` as (m, T) (or (T,) for m = 1): groups of T lanes walk each
    interval for T thetas under the union vote, and ``areas`` come back
    (m, T).

    With ``checkpoint_path`` the run goes in legs of ``checkpoint_every``
    cycles and snapshots the live bag prefix, the accumulator and the
    totals at every leg boundary, the last one before a ``max_cycles``
    exit; a finished run deletes its snapshot. At a cycle edge every
    lane, bank and half-bank has been folded back into the bag, so the
    snapshot is the whole state, and :func:`resume_family_walker`
    continues the run bit-identical to an uninterrupted one.
    ``seg_stats`` and ``cycle_stats`` then hold this process's segments
    and cycles. ``_crash_after_legs`` is a test hook that raises after
    that many snapshots; ``_dispatch_only`` returns the
    :class:`WalkerDispatch` (:func:`dispatch_family_walker`)."""
    dev = resolve_device(device)
    if lanes % 128:
        raise ValueError(f"lanes must be a multiple of 128, got {lanes}")
    if refill_slots < 0 or refill_slots > roots_per_lane:
        raise ValueError(f"refill_slots must be in [0, roots_per_lane="
                         f"{roots_per_lane}], got {refill_slots}")
    scout = resolve_scout_dtype(scout_dtype, rule)
    validate_double_buffer(double_buffer, refill_slots)
    # a registered family resolves its cadence through the tuning table
    # (the single-card signature); an ad-hoc callable has no signature
    # and keeps the hand tier
    fam = family_name_of(f_theta)
    sig = None if fam is None else workload_signature(
        fam, eps, rule, theta_block=int(theta_block), mesh_shape=1,
        scout=scout, refill_slots=int(refill_slots))
    exit_frac, suspend_frac = resolve_cadence(
        exit_frac, suspend_frac, scout, refill_slots, signature=sig,
        device=dev)
    theta2d, rep_theta = normalize_theta_batch(theta, theta_block)
    m = theta2d.shape[0]
    T = validate_theta_block(theta_block, lanes=lanes,
                             refill_slots=refill_slots, rule=rule, m=m)
    rep_theta, bounds = _family_problem(rep_theta, bounds)
    # ds transcendentals return silently wrong values outside their
    # Cody-Waite ranges: refuse up front, for every theta of every slot
    check_ds_domain(f_ds, np.repeat(bounds, T, axis=0), theta2d.reshape(-1))
    target, breed_chunk, slack_chunk = walker_sizing(
        lanes, roots_per_lane, capacity, chunk, T)

    t0 = time.perf_counter()
    if _state_override is not None:
        # a store of another sizing would make the push windows and the
        # expand grid clamp onto live entries
        want = capacity + 2 * slack_chunk
        got = int(_state_override.bag_l.shape[0])
        if got != want:
            raise ValueError(
                f"seed-state store size {got} does not match this call's "
                f"sizing {want} (= capacity + 2*slack); build the seed "
                f"with seed_family_walker_state using the SAME chunk/"
                f"capacity/lanes/roots_per_lane as the run")
    ckw = dict(f_theta=f_theta, f_ds=f_ds, eps=float(eps), m=m,
               seg_iters=int(seg_iters), max_segments=int(max_segments),
               min_active_frac=float(min_active_frac),
               exit_frac=exit_frac, suspend_frac=suspend_frac,
               lanes=int(lanes), capacity=int(capacity),
               breed_chunk=int(breed_chunk), target=int(target),
               rule=Rule(rule), refill_slots=int(refill_slots),
               scout=scout, double_buffer=bool(double_buffer),
               theta_block=T, sort_roots=bool(sort_roots),
               sort_skip_ratio=float(sort_skip_ratio))
    identity = (None if checkpoint_path is None else _walker_identity(
        f_theta, f_ds, eps, theta2d, bounds, rule, scout, double_buffer, T))
    run = functools.partial(
        _run_cycles, seed=_state_override, bounds=bounds,
        rep_theta=rep_theta, theta2d=theta2d, slack_chunk=slack_chunk,
        dev=dev, ckw=ckw, max_cycles=int(max_cycles),
        checkpoint_path=checkpoint_path,
        checkpoint_every=int(checkpoint_every), identity=identity,
        totals_override=_totals_override, crash_after_legs=_crash_after_legs)
    d = WalkerDispatch(run=run, t0=t0, lanes=int(lanes), rule=Rule(rule),
                       refill_slots=int(refill_slots), theta_block=T,
                       nan_policy=str(nan_policy),
                       checkpoint_path=checkpoint_path)
    return d if _dispatch_only else collect_family_walker(d)


def _run_cycles(*, seed, bounds, rep_theta, theta2d, slack_chunk, dev, ckw,
                max_cycles, checkpoint_path, checkpoint_every, identity,
                totals_override, crash_after_legs) -> _RunOut:
    """The cycle loop of one run, from the seed bag (a copy of
    ``seed``, or a fresh one), with snapshots at leg edges when
    ``checkpoint_path`` is set."""
    m, T = theta2d.shape[0], ckw["theta_block"]
    bag = (initial_bag(bounds, ckw["capacity"], m * T, slack_chunk,
                       theta=rep_theta, device=dev)
           if seed is None else _copy_bag(seed))
    syncs = HostSyncs()
    ckw = dict(ckw, syncs=syncs,
               theta_table=(torch.tensor(theta2d, dtype=torch.float64,
                                         device=dev) if T > 1 else None))
    f64 = torch.float64
    # the totals under the snapshot's key names; the waste buckets and
    # the scout / confirm counts stay numpy vectors between snapshots
    tot = dict(tasks=0, splits=0, btasks=0, wtasks=0, wsplits=0, roots=0,
               rounds=0, segs=0, wsteps=0, srows=0, max_depth=0)
    waste = np.zeros(N_WASTE, dtype=np.int64)
    evals = np.zeros(2, dtype=np.int64)
    cycles = est_kevals = 0
    if totals_override is not None:
        t = dict(totals_override)
        # the accumulator re-enters the same addition chain
        acc = torch.tensor(np.asarray(t.pop("acc"), dtype=np.float64),
                           dtype=f64, device=dev)
        w = [int(v) for v in t.pop("waste")]
        waste[:len(w)] = w
        evals[:] = (int(t.pop("sevals")), int(t.pop("cevals")))
        cycles = int(t.pop("cycles"))
        est_kevals = int(t.pop("est_kevals", 0))
        tot.update({k: int(v) for k, v in t.items()})
    else:
        acc = torch.zeros(m * T, dtype=f64, device=dev)
    seg_stats = np.zeros((S_CAP, len(SEG_STAT_FIELDS)), dtype=np.int64)
    psegs = 0                   # segments walked by this process
    cyc_rows = []
    syncs_per_cycle = []
    overflow = False
    legs = 0
    leg_end = max_cycles if checkpoint_path is None \
        else cycles + checkpoint_every
    while bag.count > 0 and not overflow:
        if cycles >= leg_end:
            if checkpoint_path is None:
                break
            cols, (acc_np,) = _pull_prefix(bag, syncs, acc)
            save_family_checkpoint(
                checkpoint_path, identity=identity, bag_cols=cols,
                count=bag.count, acc=acc_np, totals=dict(
                    tot, cycles=cycles, waste=waste.tolist(),
                    sevals=int(evals[0]), cevals=int(evals[1]),
                    **({} if totals_override is None
                       else {"est_kevals": est_kevals})))
            legs += 1
            if crash_after_legs is not None and legs >= crash_after_legs:
                raise RuntimeError(
                    f"simulated crash after {legs} legs (test hook)")
            # the snapshot comes before the max_cycles exit, so "raise
            # max_cycles and resume" continues from this leg
            if cycles >= max_cycles:
                break
            leg_end = cycles + checkpoint_every
        n0 = syncs.n
        o = _cycle_once(bag, gsegs0=psegs, seg_stats0=seg_stats, **ckw)
        bred, walk, bag3 = o.bred, o.walk, o.bag3
        s = walk.lanes
        wt, ws, wmaxd, bmaxd, dmaxd = syncs.pull(torch.stack([
            s.tasks.sum(dtype=torch.int64), s.splits.sum(dtype=torch.int64),
            s.maxd.max().to(torch.int64), bred.max_depth.to(torch.int64),
            bag3.max_depth.to(torch.int64)]))
        w_waste, w_evals = walk.waste, walk.evals
        bag_tasks = bred.tasks + bag3.tasks
        bag_splits = bred.splits + bag3.splits
        cyc_rows.append([bred.count, bred.iters, walk.taken, wt,
                         walk.steps, walk.segs, o.bag2_count, bag3.tasks,
                         o.srows, bag_tasks + wt, bag_splits + ws,
                         *w_waste, *w_evals])
        acc = acc + bred.acc + walk.acc + bag3.acc
        tot["tasks"] += bag_tasks + wt
        tot["splits"] += bag_splits + ws
        tot["btasks"] += bag_tasks
        tot["wtasks"] += wt
        tot["wsplits"] += ws
        tot["roots"] += walk.taken
        tot["rounds"] += bred.iters + bag3.iters
        tot["segs"] += walk.segs
        tot["wsteps"] += walk.steps
        tot["srows"] += o.srows
        tot["max_depth"] = max(tot["max_depth"], wmaxd, bmaxd, dmaxd)
        psegs += walk.segs
        waste += w_waste
        evals += w_evals
        overflow = bred.overflow or bag3.overflow
        cycles += 1
        bag = bag3.fresh_counters()
        syncs_per_cycle.append(syncs.n - n0)
    areas = np.asarray(syncs.pull(acc), dtype=np.float64)
    return _RunOut(
        areas=areas, tot=tot, waste=waste, evals=evals, cycles=cycles,
        est_kevals=est_kevals, left=bag.count, overflow=overflow,
        seg_stats=seg_stats[:min(psegs, S_CAP)].copy(), cyc_rows=cyc_rows,
        host_syncs=syncs.n, syncs_per_cycle=syncs_per_cycle,
        device=str(dev))


def quarantine_failed_mask(areas: np.ndarray, nan_policy: str,
                           engine: str) -> Optional[np.ndarray]:
    """The per-family NaN containment decision. ``nan_policy="raise"``:
    any non-finite area is an engine-wide ``FloatingPointError``.
    ``"quarantine"``: the boolean failed mask over ``areas`` (None when
    all are finite); each family's accumulator is its own slot, so a
    poisoned family cannot have touched the others' credits. Quarantined
    families count into ``ppls_quarantined_total{engine}`` of the
    process registry."""
    if nan_policy not in ("raise", "quarantine"):
        raise ValueError(
            f"nan_policy must be 'raise' or 'quarantine', got "
            f"{nan_policy!r}")
    finite = np.isfinite(areas)
    if np.all(finite):
        return None
    if nan_policy == "raise":
        bad = int(np.sum(~finite))
        raise FloatingPointError(
            f"{engine} produced {bad}/{areas.size} non-finite areas "
            f"(NaN/inf) — refusing to report garbage")
    failed = ~finite
    from ppls_tpu_torch.obs.telemetry import default_telemetry
    default_telemetry().registry.counter(
        "ppls_quarantined_total",
        "per-family results quarantined as non-finite "
        "(nan_policy='quarantine')",
        ("engine",)).labels(engine=engine).inc(int(failed.sum()))
    return failed


def collect_family_walker(d: WalkerDispatch) -> WalkerResult:
    """Walk a queued :class:`WalkerDispatch`, validate it and assemble
    its :class:`WalkerResult` (a finished run deletes its snapshot)."""
    r = d.run()
    wall = time.perf_counter() - d.t0
    if r.overflow:
        raise RuntimeError(
            "walker bag overflowed; raise capacity (on theta_block "
            "runs this also fires when a walk phase's step budget "
            "expired mid-root — raise max_segments/seg_iters; see "
            "_expand_pending's theta-suspension note)")
    if r.left > 0:
        raise RuntimeError(f"walker did not converge in {r.cycles} cycles "
                           f"({r.left} tasks left); raise max_cycles")
    areas = r.areas
    if d.theta_block > 1:
        areas = areas.reshape(-1, d.theta_block)  # T areas per slot
    failed = quarantine_failed_mask(areas, d.nan_policy, "walker")
    _clear_snapshot(d.checkpoint_path)
    tot, waste, lanes = r.tot, r.waste, d.lanes
    tasks, wtasks = tot["tasks"], tot["wtasks"]
    sevals, cevals = int(r.evals[0]), int(r.evals[1])
    kernel_evals, evals_estimated = derive_kernel_evals(
        sevals, cevals, int(waste[0]), wtasks, tot["wsplits"],
        tot["roots"], d.rule, est_kevals=r.est_kevals)
    ept = EVALS_PER_TASK[Rule(d.rule)]     # float64 evals per bag task
    cyc_stats = (np.asarray(r.cyc_rows, dtype=np.int64)[:C_CAP]
                 if r.cyc_rows else None)
    metrics = RunMetrics(
        tasks=tasks, splits=tot["splits"], leaves=tasks - tot["splits"],
        rounds=tot["rounds"] + tot["segs"], max_depth=tot["max_depth"],
        integrand_evals=ept * tot["btasks"] + kernel_evals
        + ept * tot["srows"],
        wall_time_s=wall, n_chips=1, tasks_per_chip=[tasks])
    # per-round records only when this process holds every cycle's row
    if cyc_stats is not None and r.cycles <= len(cyc_stats):
        metrics.per_round = round_stats_from_rows(
            cyc_stats, CYCLE_STAT_FIELDS, padded_width=int(lanes))
    denom = tot["wsteps"] * lanes
    return WalkerResult(
        areas=areas, metrics=metrics,
        lane_efficiency=wtasks / denom if denom else 0.0,
        walker_fraction=wtasks / tasks if tasks else 0.0,
        cycles=r.cycles, seg_stats=r.seg_stats, cycle_stats=cyc_stats,
        lanes=int(lanes), kernel_steps=tot["wsteps"],
        refill_slots=d.refill_slots, waste=waste, scout_evals=sevals,
        confirm_evals=cevals if sevals else int(waste[0]),
        evals_estimated=evals_estimated, host_syncs=r.host_syncs,
        host_syncs_per_cycle=r.syncs_per_cycle, device=r.device,
        failed=failed)


def dispatch_family_walker(
        f_theta: Callable, f_ds: Callable, theta: Sequence[float],
        bounds, eps: float, **kwargs) -> WalkerDispatch:
    """Queue a walker run: the parameters of
    :func:`integrate_family_walker` (checkpointing excluded: a
    checkpointed run syncs at its leg boundaries), validated now, walked
    by :func:`collect_family_walker`. Pass a
    :func:`seed_family_walker_state` bag as ``_state_override`` to skip
    the seed construction per run."""
    for bad in ("checkpoint_path", "checkpoint_every"):
        if kwargs.get(bad) is not None:
            raise ValueError(f"dispatch_family_walker does not support "
                             f"{bad}; use integrate_family_walker")
    return integrate_family_walker(f_theta, f_ds, theta, bounds, eps,
                                   _dispatch_only=True, **kwargs)


def resume_family_walker(
        path: str, f_theta: Callable, f_ds: Callable,
        theta: Sequence[float], bounds, eps: float,
        chunk: int = 1 << 15,
        capacity: int = 1 << 23,
        lanes: int = DEFAULT_LANES,
        roots_per_lane: int = 12,
        seg_iters: int = 2048,
        max_segments: int = 1 << 18,
        min_active_frac: float = 0.1,
        exit_frac: Optional[float] = None,
        suspend_frac: Optional[float] = None,
        max_cycles: int = 64,
        rule: Rule = Rule.TRAPEZOID,
        sort_roots: bool = True,
        refill_slots: int = 0,
        sort_skip_ratio: float = SORT_SKIP_RATIO,
        scout_dtype: Optional[str] = None,
        double_buffer: bool = False,
        theta_block: int = 1,
        nan_policy: str = "raise",
        checkpoint_every: int = 1,
        device="cuda") -> WalkerResult:
    """Continue an interrupted checkpointed walker run from its last
    cycle-boundary snapshot, on ``device`` (CUDA by default). The
    snapshot's identity, schedule modes included, must match this call's
    or a ``ValueError`` is raised. The wall time covers this process."""
    dev = resolve_device(device)
    scout = resolve_scout_dtype(scout_dtype, rule)
    theta2d, rep_theta = normalize_theta_batch(theta, theta_block)
    T = int(theta_block)
    rep_theta, bounds_np = _family_problem(rep_theta, bounds)
    identity = _walker_identity(f_theta, f_ds, eps, theta2d, bounds_np,
                                rule, scout, double_buffer, T)
    bag_cols, count, acc, totals = load_family_checkpoint(path, identity)
    # the same store sizing as integrate_family_walker
    _, _, slack_chunk = walker_sizing(lanes, roots_per_lane, capacity,
                                      chunk, T)
    fresh = initial_bag(bounds_np, capacity, theta2d.shape[0] * T,
                        slack_chunk, theta=rep_theta, device=dev)
    state = _restore_bag(
        fresh, bag_cols, count, acc=np.zeros(fresh.acc.shape[0]),
        totals={"tasks": 0, "splits": 0, "iters": 0, "max_depth": 0})
    # the reference's defaults for snapshots written before a key existed
    totals = dict(totals)
    totals.setdefault("wsteps", int(totals.get("segs", 0)) * int(seg_iters))
    totals.setdefault("srows", 0)
    totals.setdefault("waste", [0] * N_WASTE)
    totals["waste"] = list(totals["waste"]) + [0] * (
        N_WASTE - len(totals["waste"]))
    totals.setdefault("sevals", 0)
    totals.setdefault("cevals", 0)
    totals.setdefault(
        "est_kevals", estimate_legacy_kernel_evals(totals, Rule(rule)))
    totals["acc"] = acc
    return integrate_family_walker(
        f_theta, f_ds, theta, bounds, eps, chunk=chunk, capacity=capacity,
        lanes=lanes, roots_per_lane=roots_per_lane, seg_iters=seg_iters,
        max_segments=max_segments, min_active_frac=min_active_frac,
        exit_frac=exit_frac, suspend_frac=suspend_frac,
        max_cycles=max_cycles, rule=rule, sort_roots=sort_roots,
        refill_slots=refill_slots, sort_skip_ratio=sort_skip_ratio,
        scout_dtype=scout_dtype, double_buffer=double_buffer,
        theta_block=theta_block, nan_policy=nan_policy,
        checkpoint_path=path, checkpoint_every=checkpoint_every,
        device=dev, _state_override=state, _totals_override=totals)


def first_phase_inputs(f_theta: Callable, theta, bounds, eps: float, *,
                       lanes: int, roots_per_lane: int, refill_slots: int,
                       capacity: int, scout: bool,
                       rule: Rule = Rule.TRAPEZOID,
                       min_active_frac: float = 0.1, theta_block: int = 1,
                       device="cuda"):
    """The kernel operands of a run's first walk phase: breed and
    work-sort as :func:`integrate_family_walker` does, with the
    exit/suspension cadence it resolves for ``scout``, then

    * ``refill_slots`` = R > 0 (K1, single deal): deal the banks.
      Returns ``state``, ``slot``, ``nslots``, ``bank``, ``resm``,
      ``thresh`` (the suspension floor), ``batch`` and ``theta_block``;
      with ``theta_block`` = T > 1 (``theta`` (m, T)) the bank is a
      theta bank and ``thresh`` is 0;
    * ``refill_slots=0`` (K2 and K3): seed every lane off the queue top
      (the first ``_bank_and_refill``). Returns ``state`` and ``thresh``
      (the exit threshold of a segment with roots left).

    What the kernel-versus-plain checks feed both versions."""
    dev = resolve_device(device)
    theta2d, rep_theta = normalize_theta_batch(theta, theta_block)
    m = theta2d.shape[0]
    T = validate_theta_block(theta_block, lanes=lanes,
                             refill_slots=refill_slots, rule=rule, m=m)
    theta, bounds = _family_problem(rep_theta, bounds)
    exit_frac, suspend_frac = resolve_cadence(None, None, scout,
                                              refill_slots)
    target, breed_chunk, slack_chunk = walker_sizing(   # default chunk
        lanes, roots_per_lane, capacity, 1 << 15, T)
    if T > 1:
        target = theta_breed_target(target, refill_slots, lanes, T)
    bag = initial_bag(bounds, capacity, m * T, slack_chunk, theta=theta,
                      device=dev)
    bag, _ = _breed_and_sort(bag, f_theta=f_theta, eps=float(eps),
                             capacity=capacity, rule=Rule(rule),
                             breed_chunk=breed_chunk, target=target,
                             syncs=HostSyncs(),
                             breed_eps=-1.0 if T > 1 else None)
    if T > 1:
        min_active = max(1, int((lanes // T) * min_active_frac))
        bank, nslots, _navail, _dealt = deal_root_bank(
            bag, refill_slots=refill_slots, lanes=lanes,
            min_active=min_active, theta_block=T,
            theta_table=torch.tensor(theta2d, dtype=torch.float64,
                                     device=dev))
        return dict(
            state=_fresh_lanes(lanes, dev),
            slot=torch.zeros(lanes, dtype=torch.int32, device=dev),
            nslots=nslots, bank=bank, resm=_fresh_sentinel(lanes, dev),
            thresh=0, batch=max(lanes - int(lanes * exit_frac), 1),
            theta_block=T)
    min_active = int(lanes * min_active_frac)
    if not refill_slots:
        state, _acc, _n = _bank_and_refill(
            _fresh_lanes(lanes, dev),
            torch.zeros(m, dtype=torch.float64, device=dev), bag, 0, m)
        return dict(state=state, thresh=int(lanes * exit_frac))
    bank, nslots, _navail, _dealt = deal_root_bank(
        bag, refill_slots=refill_slots, lanes=lanes,
        min_active=min_active)
    return dict(
        state=_fresh_lanes(lanes, dev),
        slot=torch.zeros(lanes, dtype=torch.int32, device=dev),
        nslots=nslots, bank=bank, resm=_fresh_sentinel(lanes, dev),
        thresh=max(min_active, int(lanes * suspend_frac)),
        batch=max(lanes - int(lanes * exit_frac), 1), theta_block=1)


# ---------------------------------------------------------------------------
# Streaming hooks (runtime/stream.py): the continuous-batching engine runs
# the same cycle as integrate_family_walker, one cycle per phase, with
# admission and retirement at the host boundary between phases.
# ---------------------------------------------------------------------------

# One phase's stats row, the reference's columns in its order.
STREAM_STAT_FIELDS = ("tasks", "btasks", "wtasks", "wsplits", "roots",
                      "rounds", "segs", "wsteps", "srows", "maxd",
                      "live_tasks", "live_families", "splits",
                      "crounds") + WASTE_FIELDS + EVAL_FIELDS


def family_live_counts_cols(bag_meta: torch.Tensor, count: int,
                            m: int) -> torch.Tensor:
    """(m,) int32: live rows per family over raw (meta, count) bag
    columns, the retirement mask's primitive: family ids clipped to
    [0, m), one exact unit-weight segment sum. The reference sums over
    the whole store with weight 0 past ``count``; the live prefix gives
    the same integers."""
    dev = bag_meta.device
    if count <= 0:
        return torch.zeros(m, dtype=torch.int32, device=dev)
    ids = torch.clamp(bag_meta[:count] >> DEPTH_BITS, 0, m - 1)
    ones = torch.ones(count, dtype=torch.float64, device=dev)
    return segment_sum_auto(ids, ones, m, count).to(torch.int32)


def family_live_counts(bag: BagState, m: int) -> torch.Tensor:
    """(m,) int32 live bag rows per family. Lane state folds back into
    the bag at every cycle edge, so a family with no live row has no
    pending work anywhere: the stream's done mask is ``== 0``."""
    return family_live_counts_cols(bag.bag_meta, bag.count, m)


class StreamCycleOut(NamedTuple):
    """One streaming phase's outputs. The stats row is split between
    the columns the host loop already holds (``row``) and those counted
    on the device (``dev_row``: walker tasks, walker splits, max depth,
    live families); :func:`pull_stream_cycle` reads the device part and
    the accumulators in one sync."""

    bag: BagState            # next phase's input (counters zeroed)
    acc: torch.Tensor        # (m * T,) f64 running per-family areas
    acc_c: torch.Tensor      # (m * T,) f64 Neumaier compensation of acc
    fam_live: torch.Tensor   # (m,) i32 live rows per slot (0 = done)
    fam_last: torch.Tensor   # (m,) i32 last phase credited (-1 = never)
    row: np.ndarray          # (len(STREAM_STAT_FIELDS),) i64, host part
    dev_row: torch.Tensor    # (4,) i64 on the device


def run_stream_cycle(bag: BagState, acc: torch.Tensor, acc_c: torch.Tensor,
                     fam_last: torch.Tensor, phase: int, theta_table=None,
                     *, f_theta: Callable, f_ds: Callable, eps: float,
                     m: int, seg_iters: int, max_segments: int,
                     min_active_frac: float, exit_frac: float,
                     suspend_frac: float, lanes: int, capacity: int,
                     breed_chunk: int, target: int,
                     rule: Rule = Rule.TRAPEZOID, refill_slots: int = 0,
                     f64_rounds: int = 0, scout: bool = False,
                     double_buffer: bool = False, theta_block: int = 1,
                     sort_roots: bool = True,
                     sort_skip_ratio: float = SORT_SKIP_RATIO,
                     syncs: HostSyncs) -> StreamCycleOut:
    """ONE phase of the streaming walker: the breed -> sort -> walk ->
    expand -> drain cycle of :func:`integrate_family_walker` (the shared
    :func:`_cycle_once`, from a fresh segment count), plus the streaming
    surface: per-slot live counts (the done mask), the last phase that
    credited each slot, and the phase's stats row.

    The per-family accumulator is Neumaier-compensated across phases:
    each phase's credit (breed + walk + drain, summed in that order) is
    folded into the running pair, so the area does not depend on how
    the admission schedule split a family's leaves into phases.

    With ``f64_rounds`` = K > 0 the phase is instead up to K float64 bag
    rounds (union-refinement rounds in theta mode) and no kernel runs:
    every split decision and leaf value is then pointwise float64.

    ``phase`` is the caller's phase index. Like the batch loop this is a
    host loop over device tensors; its device reads go through
    ``syncs``."""
    T = int(theta_block)
    dev = bag.bag_l.device
    i64 = torch.int64
    if f64_rounds:
        dkw = dict(f_theta=f_theta, eps=eps, capacity=capacity,
                   max_iters=min(int(f64_rounds), 1 << 20), syncs=syncs)
        if T > 1:
            bag3 = _run_theta_bag(bag, theta_table=theta_table,
                                  theta_block=T,
                                  chunk=theta_drain_chunk(breed_chunk, T),
                                  **dkw)
        else:
            bag3 = run_bag(bag, rule=rule, chunk=breed_chunk, **dkw)
        credit = bag3.acc
        zero = torch.zeros((), dtype=i64, device=dev)
        wt = ws = zero
        maxd = bag3.max_depth
        host = dict(btasks=bag3.tasks, splits=bag3.splits, roots=0,
                    rounds=bag3.iters, segs=0, wsteps=0, srows=0)
        waste = np.zeros(N_WASTE, dtype=np.int64)
        evals = np.zeros(2, dtype=np.int64)
        overflow = bag3.overflow
    else:
        o = _cycle_once(
            bag, f_theta=f_theta, f_ds=f_ds, eps=eps, m=m,
            seg_iters=seg_iters, max_segments=max_segments,
            min_active_frac=min_active_frac, exit_frac=exit_frac,
            suspend_frac=suspend_frac, lanes=lanes, capacity=capacity,
            breed_chunk=breed_chunk, target=target, rule=rule,
            refill_slots=refill_slots, gsegs0=0,
            seg_stats0=np.zeros((S_CAP, len(SEG_STAT_FIELDS)),
                                dtype=np.int64),
            scout=scout, double_buffer=double_buffer, syncs=syncs,
            theta_block=T, theta_table=theta_table, sort_roots=sort_roots,
            sort_skip_ratio=sort_skip_ratio)
        bred, walk, bag3 = o.bred, o.walk, o.bag3
        # this phase's exact per-family credit, in the reference's order
        credit = bred.acc + walk.acc + bag3.acc
        s = walk.lanes
        wt = s.tasks.sum(dtype=i64)
        ws = s.splits.sum(dtype=i64)
        maxd = torch.maximum(torch.maximum(bred.max_depth, bag3.max_depth),
                             s.maxd.max())
        host = dict(btasks=bred.tasks + bag3.tasks,
                    splits=bred.splits + bag3.splits, roots=walk.taken,
                    rounds=bred.iters + bag3.iters, segs=walk.segs,
                    wsteps=walk.steps, srows=o.srows)
        waste, evals = walk.waste, walk.evals
        overflow = bred.overflow or bag3.overflow
    acc2, acc_c2 = kahan_add((acc, acc_c), credit)

    fam_live = family_live_counts(bag3, m)
    # fam_last is per slot; theta mode reduces the (m * T,) credit to an
    # any-theta-credited mark per slot
    credited = credit != 0.0
    if T > 1:
        credited = credited.reshape(m, T).any(dim=1)
    fam_last2 = torch.where(credited, torch.full_like(fam_last, int(phase)),
                            fam_last)

    f = STREAM_STAT_FIELDS.index
    row = np.zeros(len(STREAM_STAT_FIELDS), dtype=np.int64)
    row[f("tasks")] = host["btasks"]           # + walker tasks at the pull
    row[f("splits")] = host["splits"]          # + walker splits
    for k in ("btasks", "roots", "rounds", "segs", "wsteps", "srows"):
        row[f(k)] = host[k]
    row[f("live_tasks")] = bag3.count
    row[f(WASTE_FIELDS[0]):f(WASTE_FIELDS[0]) + N_WASTE] = waste
    row[f(EVAL_FIELDS[0]):f(EVAL_FIELDS[0]) + 2] = evals
    dev_row = torch.stack([wt, ws, maxd.to(i64),
                           (fam_live > 0).sum(dtype=i64)])
    next_bag = dataclasses.replace(bag3.fresh_counters(), overflow=overflow)
    return StreamCycleOut(bag=next_bag, acc=acc2, acc_c=acc_c2,
                          fam_live=fam_live, fam_last=fam_last2, row=row,
                          dev_row=dev_row)


def pull_stream_cycle(out: StreamCycleOut, syncs: HostSyncs):
    """The phase's one device read: ``(fam_live, acc, acc_c, fam_last,
    count, overflow, stats)`` as host values, the stats row complete."""
    m_eff, m = out.acc.shape[0], out.fam_live.shape[0]
    f64 = torch.float64
    # every value is a float64 or an integer below 2^53: one exact read
    flat = np.asarray(syncs.pull(torch.cat([
        out.acc, out.acc_c, out.fam_live.to(f64), out.fam_last.to(f64),
        out.dev_row.to(f64)])), dtype=np.float64)
    acc, acc_c = flat[:m_eff], flat[m_eff:2 * m_eff]
    fam_live = flat[2 * m_eff:2 * m_eff + m].astype(np.int32)
    fam_last = flat[2 * m_eff + m:2 * m_eff + 2 * m].astype(np.int32)
    wt, ws, maxd, nlive = (int(v) for v in flat[2 * m_eff + 2 * m:])
    f = STREAM_STAT_FIELDS.index
    stats = out.row.copy()
    stats[f("tasks")] += wt
    stats[f("splits")] += ws
    stats[f("wtasks")] = wt
    stats[f("wsplits")] = ws
    stats[f("maxd")] = maxd
    stats[f("live_families")] = nlive
    return (fam_live, acc, acc_c, fam_last, out.bag.count,
            bool(out.bag.overflow), stats)
