"""Plain float32 arithmetic behind the ds-module API: the walker's scout
pass.

The scout test only needs a split/accept decision; any decision its
float32 error could flip falls inside the guard band and is retaken in
full ds by the confirm pass. The (hi, lo) pair API (the subset the
integrand twins use) is kept so one integrand twin serves both passes,
but every ``lo`` limb is identically +0.0 and every operation is a
single rounding. Twins of these functions, in the same operation
order, are the ``sc_*`` functions of ``csrc/walk_step.cuh`` and the
scout branches of its ``f_sc_of``.
"""

from __future__ import annotations

import torch

from ppls_tpu_torch.ops.ds_kernel import (
    _INV_PI, _LN2_1, _LN2_2, _LOG2E, _PI_1, _PI_2, _PIO2_1, _PIO2_2,
    _TWO_OVER_PI, DS, f32, two_prod,
)
from ppls_tpu_torch.ops.pow2 import pow2_f32


def _z(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x)


def ds_neg(x: DS) -> DS:
    return -x[0], _z(x[0])


def ds_add(x: DS, y: DS) -> DS:
    s = x[0] + y[0]
    return s, _z(s)


def ds_sub(x: DS, y: DS) -> DS:
    s = x[0] - y[0]
    return s, _z(s)


def ds_add_f32(x: DS, b) -> DS:
    s = x[0] + b
    return s, _z(s)


def ds_mul(x: DS, y: DS) -> DS:
    p = x[0] * y[0]
    return p, _z(p)


def ds_mul_f32(x: DS, b) -> DS:
    p = x[0] * b
    return p, _z(p)


def ds_mul_pow2(x: DS, k: float) -> DS:
    return x[0] * k, _z(x[0])


def ds_div(x: DS, y: DS) -> DS:
    q = x[0] / y[0]
    return q, _z(q)


def ds_abs(x: DS) -> DS:
    return torch.abs(x[0]), _z(x[0])


def ds_where(c: torch.Tensor, x: DS, y: DS) -> DS:
    return torch.where(c, x[0], y[0]), torch.where(c, x[1], y[1])


# --- float32 sin: two-limb Cody-Waite + 5-term Taylor ------------------------

_S3 = f32(-1.0 / 6.0)
_S5 = f32(1.0 / 120.0)
_S7 = f32(-1.0 / 5040.0)
_S9 = f32(1.0 / 362880.0)
_S11 = f32(-1.0 / 39916800.0)

_C2 = f32(-0.5)
_C4 = f32(1.0 / 24.0)
_C6 = f32(-1.0 / 720.0)
_C8 = f32(1.0 / 40320.0)
_C10 = f32(-1.0 / 3628800.0)


def ds_sin(x: DS) -> DS:
    """sin(x) in float32, |x| <= ~2^22."""
    xv = x[0]
    k = torch.round(xv * _TWO_OVER_PI)
    t1, e1 = two_prod(k, _PIO2_1)
    y = (xv - t1) - (e1 + k * _PIO2_2)

    y2 = y * y
    sp = _S9 + y2 * _S11
    sp = _S7 + y2 * sp
    sp = _S5 + y2 * sp
    sp = _S3 + y2 * sp
    sin_y = y + y * y2 * sp
    cp = _C8 + y2 * _C10
    cp = _C6 + y2 * cp
    cp = _C4 + y2 * cp
    cp = _C2 + y2 * cp
    cos_y = 1.0 + y2 * cp

    q = k.to(torch.int32) & 3
    use_cos = (q & 1) == 1
    negate = q >= 2
    res = torch.where(use_cos, cos_y, sin_y)
    res = torch.where(negate, -res, res)
    return res, _z(res)


# --- float32 reduced sin: pi reduction, one polynomial -----------------------

_S13 = f32(1.0 / 6227020800.0)


def ds_sin_pi(x: DS) -> DS:
    """sin(x) in float32 by pi reduction and one polynomial (|x| <=
    ~2^22): the scout twin of ``ds_kernel.ds_sin_pi``."""
    xv = x[0]
    k = torch.round(xv * _INV_PI)
    t1, e1 = two_prod(k, _PI_1)
    y = (xv - t1) - (e1 + k * _PI_2)
    y2 = y * y
    p = _S11 + y2 * _S13
    p = _S9 + y2 * p
    p = _S7 + y2 * p
    p = _S5 + y2 * p
    p = _S3 + y2 * p
    res = y + y * y2 * p
    negate = (k.to(torch.int32) & 1) == 1
    res = torch.where(negate, -res, res)
    return res, _z(res)


# --- float32 exp: two-limb Cody-Waite ln2 reduction + 6-term Taylor ----------

_E2 = f32(0.5)
_E3 = f32(1.0 / 6.0)
_E4 = f32(1.0 / 24.0)
_E5 = f32(1.0 / 120.0)
_E6 = f32(1.0 / 720.0)
_E7 = f32(1.0 / 5040.0)


def ds_exp(x: DS) -> DS:
    """exp(x) in float32; deep underflow flushes to 0 (|x| <= ~88)."""
    xv = x[0]
    k = torch.round(xv * _LOG2E)
    t1, e1 = two_prod(k, _LN2_1)
    r = (xv - t1) - (e1 + k * _LN2_2)
    p = _E6 + r * _E7
    p = _E5 + r * p
    p = _E4 + r * p
    p = _E3 + r * p
    p = _E2 + r * p
    e = 1.0 + r * (1.0 + r * p)
    s = pow2_f32(k)
    res = e * s
    return res, _z(res)
