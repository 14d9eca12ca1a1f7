"""Depth-first subtree walker: the flagship family engine.

Each of ``lanes`` SIMD lanes walks one root interval's whole refinement
subtree depth-first with the implicit binary-tree address (i, d): the
current node of root [A, A+W] is [A + i W 2^-d, A + (i+1) W 2^-d].
Descend is ``i <<= 1``; advance after an accepted leaf strips trailing
ones. The split test and the leaf values are double-single float32
(``ops/ds_kernel.py``), accumulated lane-locally; per-family credit is
an exact segment sum at phase boundaries.

Each engine cycle (:func:`_cycle_once`):

1. BREED: the float64 bag engine refines the seed intervals until the
   bag holds enough roots (``_breed``).
2. SORT: the top of the queue is ordered by a one-step error estimate,
   a proxy for subtree work (``_order_roots_by_work``).
3. DEAL: the sorted roots are dealt round-robin into per-lane private
   root banks (``deal_root_bank``).
4. WALK: the K1 segment kernel walks the lanes and refills them from
   their banks itself (``run_segment_rf``; CUDA on the card, the plain
   PyTorch segment on the CPU), launch after launch until the bank is
   dry and occupancy falls to the suspension floor
   (``_run_walk_kernel_refill``, optionally with double-buffered
   half-banks).
5. CREDIT, EXPAND, DRAIN: one exact segment sum credits every family;
   suspended walks and untaken roots go back into the bag as explicit
   tasks (``_expand_pending``); a small remainder drains in float64.

The reference runs each phase as one compiled ``while_loop``. This port
runs a host Python loop over device-resident tensors; the points where
it reads a device value are counted (``WalkerResult.host_syncs``).

Not ported in this slice: the Simpson rule, theta blocks
(``theta_block > 1``), the legacy XLA-boundary refill
(``refill_slots=0``), checkpoint/resume and the streaming, multi-chip
and CLI surfaces (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import check_ds_domain
from ppls_tpu_torch.ops import ds_kernel as dsk
from ppls_tpu_torch.ops import scout_kernel
from ppls_tpu_torch.ops.ds import ds_from_f64, ds_to_f64
from ppls_tpu_torch.ops.ds_kernel import f32
from ppls_tpu_torch.ops.pow2 import pow2_f32, pow2_f64
from ppls_tpu_torch.ops.reduction import segment_sum_auto
from ppls_tpu_torch.ops.rules import eval_batch
from ppls_tpu_torch.parallel.bag_engine import (
    DEPTH_BITS, DEPTH_MASK, BagState, bag_step, dyn_slice, dyn_update,
    initial_bag, run_bag)
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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to ppls_tpu_torch yet ({item} in "
        f"ROADMAP.md)")


@functools.lru_cache(maxsize=None)
def scout_twin(f_ds: Callable) -> Callable:
    """The float32 scout evaluator of a ds twin (the same integrand
    through ``ops/scout_kernel.py``), with a stable identity."""
    def f_scout(x, th):
        return f_ds(x, th, dsm=scout_kernel)

    return f_scout


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
                    refill_slots: int = 0) -> Tuple[float, float]:
    """The reference's hand-tuned cadence tier: explicit values win;
    otherwise exit 0.95 / suspend 0.65 with scouting and in-kernel
    refill, 0.80 / 0.50 without. (The reference's tuning table has no
    rows for this card, so the port does not read it.)"""
    tight = bool(scout) and int(refill_slots) > 0
    if exit_frac is None:
        exit_frac = 0.95 if tight else 0.80
    if suspend_frac is None:
        suspend_frac = 0.65 if tight else 0.50
    return float(exit_frac), float(suspend_frac)


class WalkState(NamedTuple):
    """Per-lane walker state, every field a (lanes,) tensor; lane l is
    the reference's (row, col) = divmod(l, 128). ``fm``/``fq`` are
    Simpson caches the trapezoid walk carries untouched; ``mk_i``/
    ``mk_d`` are theta-block markers (0 / -1 here)."""

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
    mk_i: torch.Tensor       # int32 theta marker (unused: 0)
    mk_d: torch.Tensor       # int32 theta marker depth (unused: -1)


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


def _finish_step(s: WalkState, testing, split, val):
    """Shared tail of both steps: credit, DFS advance, counters."""
    do_split = testing & split
    ovf = do_split & (s.d >= MAX_REL_DEPTH)
    do_split = do_split & ~ovf
    accept = testing & ~split
    z = torch.zeros_like(val[0])
    acc = dsk.ds_add((s.acc_h, s.acc_l), dsk.ds_where(accept, val, (z, z)))
    t = _ctz(s.i + 1)
    fin = accept & (t >= s.d)
    adv = accept & ~fin
    i_next = torch.where(do_split, s.i * 2,
                         torch.where(adv, (s.i >> t) + 1, s.i))
    d_next = torch.where(do_split, s.d + 1,
                         torch.where(adv, s.d - t, s.d))
    counters = dict(
        acc_h=acc[0], acc_l=acc[1], i=i_next, d=d_next,
        tasks=s.tasks + testing.to(torch.int32),
        splits=s.splits + do_split.to(torch.int32),
        maxd=torch.maximum(s.maxd, torch.where(testing, s.base_d + s.d, 0)))
    return counters, do_split, adv, fin, ovf


def _step_trap(s: WalkState, f_ds: Callable, eps32: float) -> WalkState:
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

    upd, do_split, adv, fin, ovf = _finish_step(s, testing, split, val)
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


def _step_scout(s: WalkState, f_ds: Callable, eps32: float):
    """Scouting step: a float32 test of every live lane (endpoint loads
    fused in) and a full-ds confirm of every non-decisive decision, so
    credit never carries float32 error. Returns (state, scout evals,
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

    upd, do_split, adv, fin, ovf = _finish_step(s, testing, split, val)
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
                     eps: float, scout: bool):
    """K1 in plain PyTorch: up to ``cap`` steps over all lanes. It runs
    while ``k == 0 or (k < cap and (live > thresh or nref > 0))``; each
    iteration refills first when ``nref >= batch or live <= thresh``,
    classifies every lane into the waste buckets, and takes one step.

    ``state``, ``slot`` and ``resm`` are updated in place. Returns
    ``(resh, resl, counters)``: this launch's (R, lanes) result banks and
    an int32 (8,) tensor [steps, 5 waste buckets, scout evals, confirm
    evals]."""
    R, lanes = bank[0].shape
    dev = slot.device
    eps32 = f32(eps)
    st, sl, rm = state, slot, tuple(resm)
    resh = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    resl = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    wa = wd = ws = wt = se = ce = zero

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
        wa = wa + live_n
        wd = wd + dead_n
        ws = ws + stall_n
        wt = wt + (lanes - live_n - stall_n - dead_n)
        if scout:
            st, sc_n, cf_n = _step_scout(st, f_ds, eps32)
            se = se + sc_n
            ce = ce + cf_n
        else:
            st = _step_trap(st, f_ds, eps32)
        live, nref = counts()
        k += 1
    for dst, src in zip(state, st):
        dst.copy_(src)
    slot.copy_(sl)
    for dst, src in zip(resm, rm):
        dst.copy_(src)
    counters = torch.stack([torch.full_like(zero, k), wa, wd, ws, wt,
                            zero, se, ce]).to(torch.int32)
    return resh, resl, counters


# ---------------------------------------------------------------------------
# K1 on the card: the CUDA kernel (csrc/walk_rf.cu) and its wrapper
# ---------------------------------------------------------------------------

_K1_ERRORS = {
    -2: "unknown integrand family",
    -3: "lanes is not a multiple of the block size",
    -4: "the grid cannot be co-resident on this card (cooperative launch "
        "refused; the grid is never shrunk)",
}


@functools.lru_cache(maxsize=None)
def _k1_max_blocks(family: int, scout: bool, index: int) -> int:
    """Blocks of K1 that card ``index`` holds at once (queried once per
    variant and card, with that card current)."""
    from ppls_tpu_torch.utils.cuda_build import load_walk_rf
    with torch.cuda.device(index):
        n = load_walk_rf().lib.walk_rf_max_coresident_blocks(family,
                                                              int(scout))
    if n < 0:
        raise RuntimeError("K1: the occupancy query failed")
    return n


def _check_k1_operands(state: WalkState, slot, nslots, bank, resm,
                       device: torch.device) -> Tuple[int, int]:
    lanes = state.a_h.shape[0]
    R = bank[0].shape[0]
    if lanes % 128 or R < 1:
        raise ValueError(f"K1 needs lanes % 128 == 0 and R >= 1, got "
                         f"lanes={lanes}, R={R}")
    lane_i32 = [("slot", slot), ("nslots", nslots), ("resm_fam", resm[2])]
    lane_f32 = [("resm_h", resm[0]), ("resm_l", resm[1])]
    for j, name in enumerate(WalkState._fields):
        (lane_f32 if j < N_F32_FIELDS else lane_i32).append(
            (name, state[j]))
    bank_names = ("a_h", "a_l", "w_h", "w_l", "th_h", "th_l", "meta")
    checks = ([(n, t, torch.float32, (lanes,)) for n, t in lane_f32]
              + [(n, t, torch.int32, (lanes,)) for n, t in lane_i32]
              + [(f"bank.{n}", t,
                  torch.int32 if n == "meta" else torch.float32, (R, lanes))
                 for n, t in zip(bank_names, bank)])
    for name, t, dtype, shape in checks:
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"K1 operand {name}: expected contiguous {dtype} "
                f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")
    return lanes, R


def run_segment_rf(state: WalkState, slot, thresh: int, cap: int,
                   batch: int, nslots, bank, resm, *, f_ds: Callable,
                   eps: float, scout: bool):
    """One K1 segment launch. On a CUDA tensor this launches the
    hand-written kernel (``csrc/walk_rf.cu``, built at first use) on the
    current stream, or raises; on a CPU tensor it runs the plain
    PyTorch segment :func:`segment_rf_plain`. Either way ``state``,
    ``slot`` and ``resm`` are updated IN PLACE, and the return value is
    ``(resh, resl, counters)`` as documented there. ``bank`` is the
    7-tuple of (R, lanes) dealt root arrays and ``resm`` the
    (resm_h, resm_l, resm_fam) sentinel row.

    ``run_segment_rf.launches`` counts kernel launches (plain runs do
    not count)."""
    device = state.a_h.device
    if device.type == "cpu":
        return segment_rf_plain(state, slot, thresh, cap, batch, nslots,
                                bank, resm, f_ds=f_ds, eps=eps,
                                scout=scout)
    if device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {device}")
    family = getattr(f_ds, "kernel_family", None)
    if family is None:
        raise ValueError(
            f"{getattr(f_ds, '__name__', f_ds)!r} has no CUDA kernel "
            f"integrand (kernel_family); registered ds twins carry one")
    lanes, R = _check_k1_operands(state, slot, nslots, bank, resm, device)
    from ppls_tpu_torch.utils.cuda_build import load_walk_rf
    lib = load_walk_rf().lib
    resh = torch.zeros((R, lanes), dtype=torch.float32, device=device)
    resl = torch.zeros((R, lanes), dtype=torch.float32, device=device)
    counters = torch.zeros(8, dtype=torch.int32, device=device)
    sync = torch.zeros(6, dtype=torch.int32, device=device)
    operands = (*state, nslots, slot, *bank, *resm, resh, resl, counters,
                sync)
    # the pointer table goes up through pinned memory, so the copy is
    # stream-ordered and does not wait for the stream to drain
    ptrs = torch.tensor([t.data_ptr() for t in operands],
                        dtype=torch.int64).pin_memory().to(
                            device, non_blocking=True)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    max_blocks = _k1_max_blocks(int(family), bool(scout), index)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        rc = lib.walk_rf_launch(ptrs.data_ptr(), lanes, R, int(family),
                                int(bool(scout)), f32(eps), int(thresh),
                                int(cap), int(batch), max_blocks, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: "
                           f"{_K1_ERRORS.get(rc, f'cudaError {rc}')}")
    run_segment_rf.launches += 1
    return resh, resl, counters


run_segment_rf.launches = 0


# ---------------------------------------------------------------------------
# Orchestration: breed, sort, deal, walk, expand, drain
# ---------------------------------------------------------------------------


def walker_sizing(lanes: int, roots_per_lane: int, capacity: int,
                  chunk: int):
    """``(target, breed_chunk, slack_chunk)``: the breed root target,
    the breeding pop width, and the store slack that keeps the bag's
    push windows and the expand-pending grid from ever clamping."""
    target = min(roots_per_lane * lanes, capacity // 2)
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
                    breed_chunk, target, syncs):
    """Graduated breed (rising chunk widths bound each round's wasted
    lanes ~2x) up to ``target`` roots, then the work sort of the queue
    top. Returns ``(bred, scored_rows)``."""
    bkw = dict(f_theta=f_theta, eps=eps, capacity=capacity, rule=rule,
               syncs=syncs)
    for pc in (1 << 14, 1 << 16, 1 << 18):
        if pc < breed_chunk:
            bag = _breed(bag, chunk=pc, target=min(pc // 2, target), **bkw)
    bag = _breed(bag, chunk=breed_chunk, target=target, **bkw)
    return _order_roots_by_work(bag, f_theta=f_theta, eps=eps, rule=rule,
                                window=2 * breed_chunk,
                                skip_ratio=SORT_SKIP_RATIO, syncs=syncs)


def _order_roots_by_work(bag: BagState, *, f_theta, eps, rule, window,
                         skip_ratio, syncs):
    """Stable-sort the top ``window`` of the root queue ascending by the
    one-step float64 error estimate (a proxy for subtree work), in
    place. NaN keys become +inf so a NaN root stays in the live prefix
    and surfaces loudly later. Skips the sort when every live key is
    finite and within ``skip_ratio`` of each other. Returns
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
                   min_active: int, offset: int = 0):
    """Deal the top ``min(count - offset, R*lanes)`` work-sorted roots
    round-robin into per-lane root banks: root p (biggest-first off the
    queue top) goes to lane p % lanes, slot p // lanes. A queue below
    ``min_active`` deals nothing. Returns ``(bank, nslots, navail,
    dealt)``: the 7-tuple of (R, lanes) bank arrays (ds limbs of left
    endpoint, width and theta, plus the meta word), the per-lane dealt
    counts, the dealt root count, and the flat (R*lanes,) dealt columns
    (l, r, th, meta)."""
    R = int(refill_slots)
    cap_roots = R * lanes
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

    limbs = [t.reshape(R, lanes) for x in (dl, dr - dl, dth)
             for t in ds_from_f64(x)]
    bank = (*limbs, dmeta.reshape(R, lanes))
    lane_ids = torch.arange(lanes, dtype=torch.int32, device=dev)
    nslots = torch.clamp(
        torch.div(navail - lane_ids + lanes - 1, lanes,
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
    waste: torch.Tensor       # (N_WASTE,) int64
    evals: torch.Tensor       # (2,) int64
    slot: torch.Tensor        # roots taken per lane
    nslots: torch.Tensor      # roots dealt per lane
    dealt: tuple              # flat (R*lanes,) l, r, th, meta
    taken: int                # roots consumed this phase


def _lane_summary(s: WalkState, slot, nslots):
    """(live, min slot, sum slot, takeable) as one int64 vector."""
    return torch.stack([
        ((s.flags & _PARKED) == 0).sum(), slot.min().to(torch.int64),
        slot.sum(dtype=torch.int64), _takeable(s, slot, nslots).sum()])


def _run_walk_kernel_refill(bag: BagState, *, f_ds, eps, m, seg_iters,
                            max_segments, min_active_frac, exit_frac,
                            suspend_frac, lanes, gsegs0, seg_stats0,
                            refill_slots, scout, double_buffer,
                            syncs) -> _WalkOut:
    """One walk phase with in-kernel refill: deal the work-sorted queue
    into per-lane banks, launch K1 until the banks are dry and
    occupancy is at the suspension floor (or the step budget is spent),
    then credit every family with ONE exact segment sum.

    With ``double_buffer`` the R slots are two rolling half-banks: when
    every lane has consumed the active half and the queue still has
    roots, the retiring half is credited, the shadow half shifts down
    and a fresh shadow half is dealt, so one phase consumes the whole
    sorted queue."""
    R = int(refill_slots)
    dev = bag.bag_l.device
    cap_roots = R * lanes
    min_active = int(lanes * min_active_frac)
    floor = max(min_active, int(lanes * suspend_frac))
    batch = max(lanes - int(lanes * exit_frac), 1)
    step_budget = max_segments * seg_iters
    top = bag.count
    f64 = torch.float64

    s = _fresh_lanes(lanes, dev)
    slot = torch.zeros(lanes, dtype=torch.int32, device=dev)
    resh = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    resl = torch.zeros((R, lanes), dtype=torch.float32, device=dev)
    resm = _fresh_sentinel(lanes, dev)
    acc_sw = torch.zeros(m, dtype=f64, device=dev)
    waste = torch.zeros(N_WASTE, dtype=torch.int64, device=dev)
    evals = torch.zeros(2, dtype=torch.int64, device=dev)
    stats = seg_stats0
    steps = segs = taken = retired = 0
    gsegs = gsegs0

    if double_buffer:
        Rh = R // 2
        half_roots = Rh * lanes
        bank_a, nsl_a, navail_a, dealt_a = deal_root_bank(
            bag, refill_slots=Rh, lanes=lanes, min_active=min_active)
        # the first shadow half only behind a FULL active half
        gate_s = 1 if navail_a == half_roots else 1 << 30
        bank_s, nsl_s, navail_s, dealt_s = deal_root_bank(
            bag, refill_slots=Rh, lanes=lanes, min_active=gate_s,
            offset=navail_a)
        bank = tuple(torch.cat([a, b]) for a, b in zip(bank_a, bank_s))
        nslots = nsl_a + nsl_s
        dealt = tuple(torch.cat([a, b]) for a, b in zip(dealt_a, dealt_s))
        consumed = navail_a + navail_s
    else:
        bank, nslots, consumed, dealt = deal_root_bank(
            bag, refill_slots=R, lanes=lanes, min_active=min_active)

    live, _, _, nref = syncs.pull(_lane_summary(s, slot, nslots))
    while steps < step_budget and (live > floor or nref > 0):
        cap = min(max(step_budget - steps, 1), seg_iters)
        rh, rl, ctr = run_segment_rf(s, slot, floor, cap, batch, nslots,
                                     bank, resm, f_ds=f_ds, eps=eps,
                                     scout=scout)
        resh += rh
        resl += rl
        waste += ctr[1:1 + N_WASTE].to(torch.int64)
        evals += ctr[1 + N_WASTE:3 + N_WASTE].to(torch.int64)
        summary = torch.cat([ctr[:1].to(torch.int64),
                             _lane_summary(s, slot, nslots)])
        si, live, min_slot, sum_slot, nref = syncs.pull(summary)
        taken2 = retired + sum_slot
        # queue left at launch: the undealt queue (rolling deal) or the
        # untaken dealt roots (single deal), as the reference records
        row = (si, live, top - (consumed if double_buffer else taken),
               taken2 - taken)
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
            acc_sw = acc_sw + segment_sum_auto(ids, contrib, m,
                                               half_roots + lanes)
            bank_n, nsl_n, navail_n, dealt_n = deal_root_bank(
                bag, refill_slots=Rh, lanes=lanes, min_active=1,
                offset=consumed)
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
        acc0 = acc_sw + segment_sum_auto(resm[2], ds_to_f64(resm), m,
                                         lanes)

    # phase-end credit: completed roots from the result bank (ids from
    # the dealt meta) + every lane's in-flight accumulator
    has_root = (s.flags & _NO_ROOT) == 0
    lane_contrib = torch.where(has_root, ds_to_f64((s.acc_h, s.acc_l)),
                               0.0)
    grid_contrib = ds_to_f64((resh, resl)).reshape(-1)
    ids = torch.cat([s.fam, dealt[3] >> DEPTH_BITS])
    contrib = torch.cat([lane_contrib, grid_contrib])
    acc = acc0 + segment_sum_auto(ids, contrib, m, lanes + cap_roots)
    return _WalkOut(lanes=s, cursor=consumed, acc=acc, segs=segs,
                    steps=steps, gsegs=gsegs, seg_stats=stats, waste=waste,
                    evals=evals, slot=slot, nslots=nslots, dealt=dealt,
                    taken=taken)


def _expand_pending(walk: _WalkOut, bag: BagState, capacity: int, m: int,
                    syncs: HostSyncs) -> BagState:
    """Convert un-walked state back into explicit bag tasks, in place.

    Roots were dealt off the TOP of the bag, so the never-dealt
    remainder [0, count - cursor) is already a valid bag prefix. The
    suspended lanes' pending sets (the current node (i, d) plus the right
    sibling (i >> k) + 1 at depth d - k for every zero bit k < d) and the
    dealt roots a lane never reached are compacted with one stable sort
    and pushed on top of it."""
    s = walk.lanes
    dev = s.i.device
    has_root = (s.flags & _NO_ROOT) == 0
    parked = (s.flags & _PARKED) != 0
    ovf = (s.flags & _OVF) != 0
    suspended = (has_root & ~parked) | ovf

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
    meta_n = ((s.fam[None, :] << DEPTH_BITS)
              + torch.clamp(s.base_d[None, :] + node_d, max=DEPTH_MASK))
    th_n = th[None, :].expand_as(ln)

    # dealt roots a lane never reached (slot <= k < nslots) re-enter too
    lanes = s.i.shape[0]
    Rk = walk.dealt[3].shape[0] // lanes
    kk = torch.arange(Rk, dtype=torch.int32, device=dev)[:, None]
    valid_u = (kk >= walk.slot[None, :]) & (kk < walk.nslots[None, :])
    ln = torch.cat([ln, walk.dealt[0].reshape(Rk, lanes)])
    rn = torch.cat([rn, walk.dealt[1].reshape(Rk, lanes)])
    th_n = torch.cat([th_n, walk.dealt[2].reshape(Rk, lanes)])
    meta_n = torch.cat([meta_n, walk.dealt[3].reshape(Rk, lanes)])
    valid = torch.cat([valid, valid_u])

    key = (~valid).reshape(-1).to(torch.int32)
    _, order = torch.sort(key, stable=True)
    sl, sr, sth, smeta = (x.reshape(-1)[order]
                          for x in (ln, rn, th_n, meta_n))
    n_pend = int(syncs.pull(valid.sum()))
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
        overflow=n_tasks > capacity)


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
                gsegs0, seg_stats0, scout, double_buffer,
                syncs) -> _CycleOut:
    """One engine cycle: graduated breed -> work sort -> walk ->
    expand -> drain (only below the walker's engagement floor, and only
    until the frontier regrows past the root target)."""
    bred, srows = _breed_and_sort(
        bag, f_theta=f_theta, eps=eps, capacity=capacity, rule=rule,
        breed_chunk=breed_chunk, target=target, syncs=syncs)
    walk = _run_walk_kernel_refill(
        bred, f_ds=f_ds, eps=eps, m=m, seg_iters=seg_iters,
        max_segments=max_segments, min_active_frac=min_active_frac,
        exit_frac=exit_frac, suspend_frac=suspend_frac, lanes=lanes,
        gsegs0=gsegs0, seg_stats0=seg_stats0, refill_slots=refill_slots,
        scout=scout, double_buffer=double_buffer, syncs=syncs)
    bag2 = _expand_pending(walk, bred, capacity, m, syncs)
    bag3 = bag2
    if bag2.count < max(1, int(lanes * min_active_frac)):
        bag3 = run_bag(bag2, f_theta=f_theta, eps=eps, rule=rule,
                       chunk=breed_chunk, capacity=capacity,
                       max_iters=1 << 20, syncs=syncs, stop_count=target)
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
    host_syncs: int = 0                       # device reads by the host
    host_syncs_per_cycle: Optional[list] = None
    device: str = ""

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
            "dominant_waste": max(waste_only, key=waste_only.get),
        }


def _family_problem(theta, bounds):
    """theta as (m,) float64 and bounds as (m, 2) float64 (one (a, b)
    pair is shared by every member)."""
    theta = np.asarray(theta, dtype=np.float64).reshape(-1)
    bounds = np.asarray(bounds, dtype=np.float64)
    if bounds.ndim == 1:
        bounds = np.tile(bounds.reshape(1, 2), (theta.shape[0], 1))
    return theta, bounds


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
        refill_slots: int = 0,
        scout_dtype: Optional[str] = None,
        double_buffer: bool = False,
        theta_block: int = 1,
        device="cuda") -> WalkerResult:
    """Flagship integration of the family ``f_theta(x, theta_i)`` over
    ``bounds``: cycles of breed -> sort -> deal -> walk -> expand ->
    drain. ``f_ds`` is the family's ds twin (``get_family_ds``); on CUDA
    its ``kernel_family`` selects the integrand compiled into K1.

    The reference entry point's parameters and defaults, plus ``device``
    (CUDA by default; raises without a card unless ``device="cpu"`` is
    passed, which runs the plain PyTorch segment). ``refill_slots`` must
    be > 0 in this slice; the root sort always runs (the reference's
    ``sort_roots``/``sort_skip_ratio`` are fixed at their defaults) and
    a non-finite area always raises (no ``nan_policy``)."""
    dev = resolve_device(device)
    if Rule(rule) != Rule.TRAPEZOID:
        raise _not_ported("Rule.SIMPSON in the walker",
                          "Queue 2, K1 Simpson mode")
    if int(theta_block) != 1:
        raise _not_ported("theta_block > 1", "Queue 2, K1 theta mode")
    if int(refill_slots) == 0:
        raise _not_ported("refill_slots=0 (the XLA-boundary refill)",
                          "Queue 2, K2")
    if lanes % 128:
        raise ValueError(f"lanes must be a multiple of 128, got {lanes}")
    if refill_slots < 0 or refill_slots > roots_per_lane:
        raise ValueError(f"refill_slots must be in [0, roots_per_lane="
                         f"{roots_per_lane}], got {refill_slots}")
    scout = resolve_scout_dtype(scout_dtype, rule)
    validate_double_buffer(double_buffer, refill_slots)
    exit_frac, suspend_frac = resolve_cadence(exit_frac, suspend_frac,
                                              scout, refill_slots)
    theta, bounds = _family_problem(theta, bounds)
    m = theta.shape[0]
    # ds transcendentals return silently wrong values outside their
    # Cody-Waite ranges: refuse up front
    check_ds_domain(f_ds, bounds, theta)
    target, breed_chunk, slack_chunk = walker_sizing(
        lanes, roots_per_lane, capacity, chunk)

    syncs = HostSyncs()
    t0 = time.perf_counter()
    bag = initial_bag(bounds, capacity, m, slack_chunk, theta=theta,
                      device=dev)
    ckw = dict(f_theta=f_theta, f_ds=f_ds, eps=float(eps), m=m,
               seg_iters=int(seg_iters), max_segments=int(max_segments),
               min_active_frac=float(min_active_frac),
               exit_frac=exit_frac, suspend_frac=suspend_frac,
               lanes=int(lanes), capacity=int(capacity),
               breed_chunk=int(breed_chunk), target=int(target),
               rule=Rule(rule), refill_slots=int(refill_slots),
               scout=scout, double_buffer=bool(double_buffer), syncs=syncs)
    f64 = torch.float64
    acc = torch.zeros(m, dtype=f64, device=dev)
    tot = dict(tasks=0, splits=0, btasks=0, wtasks=0, wsplits=0, roots=0,
               rounds=0, segs=0, wsteps=0, srows=0, maxd=0)
    waste = np.zeros(N_WASTE, dtype=np.int64)
    evals = np.zeros(2, dtype=np.int64)
    seg_stats = np.zeros((S_CAP, len(SEG_STAT_FIELDS)), dtype=np.int64)
    cyc_rows = []
    syncs_per_cycle = []
    cycles = 0
    overflow = False
    while bag.count > 0 and cycles < max_cycles and not overflow:
        n0 = syncs.n
        o = _cycle_once(bag, gsegs0=tot["segs"], seg_stats0=seg_stats,
                        **ckw)
        bred, walk, bag3 = o.bred, o.walk, o.bag3
        s = walk.lanes
        cyc = syncs.pull(torch.cat([
            torch.stack([s.tasks.sum(dtype=torch.int64),
                         s.splits.sum(dtype=torch.int64),
                         s.maxd.max().to(torch.int64),
                         bred.max_depth.to(torch.int64),
                         bag3.max_depth.to(torch.int64)]),
            walk.waste, walk.evals]))
        wt, ws, wmaxd, bmaxd, dmaxd = cyc[:5]
        w_waste = np.asarray(cyc[5:5 + N_WASTE], dtype=np.int64)
        w_evals = np.asarray(cyc[5 + N_WASTE:], dtype=np.int64)
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
        tot["maxd"] = max(tot["maxd"], wmaxd, bmaxd, dmaxd)
        waste += w_waste
        evals += w_evals
        overflow = bred.overflow or bag3.overflow
        cycles += 1
        bag = bag3.fresh_counters()
        syncs_per_cycle.append(syncs.n - n0)
    areas = np.asarray(syncs.pull(acc), dtype=np.float64)
    wall = time.perf_counter() - t0

    if overflow:
        raise RuntimeError("walker bag overflowed; raise capacity")
    if bag.count > 0:
        raise RuntimeError(f"walker did not converge in {cycles} cycles "
                           f"({bag.count} tasks left); raise max_cycles")
    if not np.all(np.isfinite(areas)):
        raise FloatingPointError(
            f"walker produced {int(np.sum(~np.isfinite(areas)))}/{m} "
            f"non-finite areas (NaN/inf); refusing to report them")
    tasks, wtasks = tot["tasks"], tot["wtasks"]
    sevals, cevals = int(evals[0]), int(evals[1])
    # kernel evals are device-counted: scout + confirm in scout mode,
    # the eval_active bucket otherwise (one real eval per live step)
    kernel_evals = (sevals + cevals) if sevals else int(waste[0])
    cyc_stats = (np.asarray(cyc_rows, dtype=np.int64)[:C_CAP]
                 if cyc_rows else None)
    metrics = RunMetrics(
        tasks=tasks, splits=tot["splits"], leaves=tasks - tot["splits"],
        rounds=tot["rounds"] + tot["segs"], max_depth=tot["maxd"],
        integrand_evals=3 * tot["btasks"] + kernel_evals + 3 * tot["srows"],
        wall_time_s=wall, n_chips=1, tasks_per_chip=[tasks])
    if cyc_stats is not None and cycles <= C_CAP:
        metrics.per_round = round_stats_from_rows(
            cyc_stats, CYCLE_STAT_FIELDS, padded_width=int(lanes))
    denom = tot["wsteps"] * lanes
    return WalkerResult(
        areas=areas, metrics=metrics,
        lane_efficiency=wtasks / denom if denom else 0.0,
        walker_fraction=wtasks / tasks if tasks else 0.0,
        cycles=cycles,
        seg_stats=seg_stats[:min(tot["segs"], S_CAP)].copy(),
        cycle_stats=cyc_stats, lanes=int(lanes),
        kernel_steps=tot["wsteps"], refill_slots=int(refill_slots),
        waste=waste, scout_evals=sevals,
        confirm_evals=cevals if sevals else int(waste[0]),
        host_syncs=syncs.n,
        host_syncs_per_cycle=syncs_per_cycle, device=str(dev))


def first_phase_inputs(f_theta: Callable, theta, bounds, eps: float, *,
                       lanes: int, roots_per_lane: int, refill_slots: int,
                       capacity: int, scout: bool,
                       min_active_frac: float = 0.1, device="cuda"):
    """The K1 operands of a run's first walk phase (single deal): breed,
    work-sort and deal as :func:`integrate_family_walker` does, with the
    exit/suspension cadence it resolves for ``scout``. Returns a dict of
    ``state``, ``slot``, ``nslots``, ``bank``, ``resm``, ``thresh`` and
    ``batch`` — what the kernel-versus-plain checks feed both versions."""
    dev = resolve_device(device)
    theta, bounds = _family_problem(theta, bounds)
    exit_frac, suspend_frac = resolve_cadence(None, None, scout,
                                              refill_slots)
    target, breed_chunk, slack_chunk = walker_sizing(   # default chunk
        lanes, roots_per_lane, capacity, 1 << 15)
    bag = initial_bag(bounds, capacity, theta.shape[0], slack_chunk,
                      theta=theta, device=dev)
    bag, _ = _breed_and_sort(bag, f_theta=f_theta, eps=float(eps),
                             capacity=capacity, rule=Rule.TRAPEZOID,
                             breed_chunk=breed_chunk, target=target,
                             syncs=HostSyncs())
    min_active = int(lanes * min_active_frac)
    bank, nslots, _navail, _dealt = deal_root_bank(
        bag, refill_slots=refill_slots, lanes=lanes,
        min_active=min_active)
    return dict(
        state=_fresh_lanes(lanes, dev),
        slot=torch.zeros(lanes, dtype=torch.int32, device=dev),
        nslots=nslots, bank=bank, resm=_fresh_sentinel(lanes, dev),
        thresh=max(min_active, int(lanes * suspend_frac)),
        batch=max(lanes - int(lanes * exit_frac), 1))
