"""Carry state between the reference's layouts and the port's tensors.

The reference keeps walker lane state as (rows, 128) arrays, root and
result banks as (R, rows, 128), and the task bags (1D and 2D) as flat
columns. The
port keeps lanes flat: lane = row * 128 + col. These helpers convert
numpy arrays in the reference's layout (as ``jax.device_get`` returns
them) into the port's tensors and back, so one set of inputs can be fed
to both packages. Nothing here imports the reference package.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from ppls_tpu_torch.parallel.bag_engine import BagState
from ppls_tpu_torch.parallel.cubature import RectBag
from ppls_tpu_torch.parallel.walker import N_F32_FIELDS, WalkState

LANE_MINOR = 128


def lanes_from_numpy(a, dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """(rows, 128) or (R, rows, 128) -> (lanes,) or (R, lanes), always a
    fresh copy: the reference builds several state fields from one
    buffer, and the port updates its state in place."""
    a = np.asarray(a)
    lead = a.shape[:-2]
    return torch.tensor(a.reshape(*lead, -1), dtype=dtype, device=device)


def lanes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """(lanes,) or (R, lanes) -> (rows, 128) or (R, rows, 128)."""
    a = t.detach().cpu().numpy()
    return a.reshape(*a.shape[:-1], -1, LANE_MINOR)


def _field_dtype(j: int) -> torch.dtype:
    return torch.float32 if j < N_F32_FIELDS else torch.int32


def walk_state_from_numpy(fields: Sequence, device="cpu") -> WalkState:
    """The reference's WalkState (26 arrays of (rows, 128), in field
    order) -> the port's WalkState of (lanes,) tensors."""
    if len(fields) != len(WalkState._fields):
        raise ValueError(f"expected {len(WalkState._fields)} fields, got "
                         f"{len(fields)}")
    return WalkState(*(lanes_from_numpy(a, _field_dtype(j), device)
                       for j, a in enumerate(fields)))


def walk_state_to_numpy(state: WalkState) -> Tuple[np.ndarray, ...]:
    return tuple(lanes_to_numpy(t) for t in state)


def bank_from_numpy(bank: Sequence, device="cpu") -> Tuple[torch.Tensor, ...]:
    """The 7 (R, rows, 128) root-bank arrays (a_h, a_l, w_h, w_l, th_h,
    th_l, meta) -> 7 (R, lanes) tensors."""
    return tuple(lanes_from_numpy(
        a, torch.int32 if j == 6 else torch.float32, device)
        for j, a in enumerate(bank))


def bank_to_numpy(bank: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    return tuple(lanes_to_numpy(t) for t in bank)


def theta_table_from_numpy(theta_table, device="cpu") -> torch.Tensor:
    """A theta mode's (m, T) float64 theta table -> a float64 tensor. Its
    theta bank is an ordinary bank (:func:`bank_from_numpy`) whose rows
    are lane-expanded."""
    return torch.tensor(np.asarray(theta_table, dtype=np.float64),
                        dtype=torch.float64, device=device)


def sentinel_from_numpy(resm: Sequence, device="cpu"):
    """(resm_h, resm_l, resm_fam), each (rows, 128) -> (lanes,)."""
    return (lanes_from_numpy(resm[0], torch.float32, device),
            lanes_from_numpy(resm[1], torch.float32, device),
            lanes_from_numpy(resm[2], torch.int32, device))


def bag_state_from_numpy(cols: Mapping, device="cpu") -> BagState:
    """The reference BagState's fields as numpy values (bag_l, bag_r,
    bag_th, bag_meta, count, acc, tasks, splits, iters, max_depth,
    overflow) -> the port's BagState."""
    dev = torch.device(device)
    f64 = torch.float64
    return BagState(
        bag_l=torch.tensor(np.asarray(cols["bag_l"]), dtype=f64,
                           device=dev),
        bag_r=torch.tensor(np.asarray(cols["bag_r"]), dtype=f64,
                           device=dev),
        bag_th=torch.tensor(np.asarray(cols["bag_th"]), dtype=f64,
                            device=dev),
        bag_meta=torch.tensor(np.asarray(cols["bag_meta"]),
                              dtype=torch.int32, device=dev),
        count=int(cols["count"]),
        acc=torch.tensor(np.asarray(cols["acc"]), dtype=f64, device=dev),
        tasks=int(cols.get("tasks", 0)), splits=int(cols.get("splits", 0)),
        iters=int(cols.get("iters", 0)),
        max_depth=torch.as_tensor(int(cols.get("max_depth", 0)),
                                  dtype=torch.int32, device=dev),
        overflow=bool(cols.get("overflow", False)))


def bag_state_to_numpy(state: BagState) -> dict:
    return dict(
        bag_l=state.bag_l.cpu().numpy(), bag_r=state.bag_r.cpu().numpy(),
        bag_th=state.bag_th.cpu().numpy(),
        bag_meta=state.bag_meta.cpu().numpy(), count=state.count,
        acc=state.acc.cpu().numpy(), tasks=state.tasks,
        splits=state.splits, iters=state.iters,
        max_depth=int(state.max_depth), overflow=state.overflow)


def rect_bag_from_numpy(fields: Sequence, device="cpu") -> RectBag:
    """The reference's 2D RectBag as numpy values, in its field order
    (lx, rx, ly, ry, meta, count, acc, tasks, splits, iters, max_depth,
    overflow; ``jax.device_get`` of the NamedTuple) -> the port's
    RectBag, on fresh storage."""
    if len(fields) != len(RectBag.__dataclass_fields__):
        raise ValueError(f"expected {len(RectBag.__dataclass_fields__)} "
                         f"fields, got {len(fields)}")
    lx, rx, ly, ry, meta, count, acc, tasks, splits, iters, maxd, ovf = \
        fields
    dev = torch.device(device)

    def col(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    f64 = torch.float64
    return RectBag(
        lx=col(lx, f64), rx=col(rx, f64), ly=col(ly, f64), ry=col(ry, f64),
        meta=col(meta, torch.int32), count=int(count), acc=col(acc, f64),
        tasks=int(tasks), splits=int(splits), iters=int(iters),
        max_depth=col(maxd, torch.int32), overflow=bool(ovf))


def rect_bag_to_numpy(state: RectBag) -> tuple:
    """The port's RectBag -> numpy values in the reference's field
    order."""
    return (state.lx.cpu().numpy(), state.rx.cpu().numpy(),
            state.ly.cpu().numpy(), state.ry.cpu().numpy(),
            state.meta.cpu().numpy(), state.count,
            state.acc.cpu().numpy(), state.tasks, state.splits, state.iters,
            state.max_depth.cpu().numpy(), state.overflow)
