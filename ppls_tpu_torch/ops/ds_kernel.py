"""Double-single (two-float32) arithmetic: the plain PyTorch version of
the walk kernel's device library.

Every function here has a ``__host__ __device__`` twin in
``csrc/walk_step.cuh`` that performs the same float32 operations in the
same order; the kernel is built with ``-fmad=false`` so no multiply-add
is contracted, and PyTorch runs each elementwise op as its own IEEE
operation. The two therefore agree bit for bit, which is what the
kernel-versus-plain checks hold them to.

Only elementwise ``+ - * /`` are used (no ``addcmul``, no ``torch.fma``,
no division by a Python scalar, which PyTorch may turn into a multiply
by the reciprocal). Scalar constants are float32 values: a Python float
argument is one whose float32 rounding is itself.

Same algorithms as the reference ds library: Dekker/Knuth error-free
transforms, Cody-Waite three-term reduction, ds-leading Taylor
polynomials.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch

from ppls_tpu_torch.ops.pow2 import pow2_f32

DS = Tuple[torch.Tensor, torch.Tensor]
Num = Union[torch.Tensor, float]

_SPLIT = 4097.0  # Dekker splitter for float32: 2^12 + 1


def f32(v: float) -> float:
    """The float32 rounding of ``v``, as a Python float (exact)."""
    return float(np.float32(v))


def two_sum(a: Num, b: Num) -> DS:
    """s + e == a + b exactly (no magnitude precondition)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a: Num, b: Num) -> DS:
    """s + e == a + b exactly, requires |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _dekker_split(a: torch.Tensor):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


@functools.lru_cache(maxsize=64)
def _dekker_split_scalar(b: float):
    """Dekker split of a float32 constant, in float32 arithmetic."""
    b32 = np.float32(b)
    t = np.float32(np.float32(_SPLIT) * b32)
    hi = np.float32(t - np.float32(t - b32))
    return float(hi), float(np.float32(b32 - hi))


def two_prod(a: torch.Tensor, b: Num) -> DS:
    """p + e == a * b exactly (Dekker product, no FMA)."""
    p = a * b
    ah, al = _dekker_split(a)
    if isinstance(b, torch.Tensor):
        bh, bl = _dekker_split(b)
    else:
        bh, bl = _dekker_split_scalar(float(b))
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_neg(x: DS) -> DS:
    return -x[0], -x[1]


def ds_add(x, y) -> DS:
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def ds_sub(x: DS, y: DS) -> DS:
    return ds_add(x, ds_neg(y))


def ds_add_f32(x: DS, b: Num) -> DS:
    s, e = two_sum(x[0], b)
    e = e + x[1]
    return quick_two_sum(s, e)


def ds_mul(x: DS, y: DS) -> DS:
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def ds_mul_f32(x: DS, b: Num) -> DS:
    p, e = two_prod(x[0], b)
    e = e + x[1] * b
    return quick_two_sum(p, e)


def ds_mul_pow2(x: DS, k: float) -> DS:
    """Exact scaling by a power of two."""
    return x[0] * k, x[1] * k


def ds_div(x: DS, y: DS) -> DS:
    """One long-division refinement on the float32 quotient seed."""
    q1 = x[0] / y[0]
    p, pe = two_prod(q1, y[0])
    r = ds_sub(x, (p, pe + q1 * y[1]))
    q2 = (r[0] + r[1]) / y[0]
    return quick_two_sum(q1, q2)


def ds_abs(x: DS) -> DS:
    neg = x[0] < 0
    return torch.where(neg, -x[0], x[0]), torch.where(neg, -x[1], x[1])


def ds_where(c: torch.Tensor, x: DS, y: DS) -> DS:
    return torch.where(c, x[0], y[0]), torch.where(c, x[1], y[1])


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """int32 popcount of a boolean lane mask (a 0-dim tensor)."""
    return mask.sum(dtype=torch.int32)


# --- sin: Cody-Waite pi/2 reduction + ds-leading Taylor ----------------------

def _c(v: float):
    hi = np.float32(v)
    return float(hi), float(np.float32(v - float(hi)))


_PIO2_1 = f32(1.5707963267948966)
_PIO2_2 = f32(1.5707963267948966 - _PIO2_1)
_PIO2_3 = f32(1.5707963267948966 - _PIO2_1 - _PIO2_2)
_TWO_OVER_PI = f32(0.6366197723675814)

_S3 = _c(-1.0 / 6.0)
_S5 = _c(1.0 / 120.0)
_S7 = _c(-1.0 / 5040.0)
_S9 = _c(1.0 / 362880.0)
_S11 = f32(-1.0 / 39916800.0)
_S13 = f32(1.0 / 6227020800.0)

_C2 = _c(-0.5)
_C4 = _c(1.0 / 24.0)
_C6 = _c(-1.0 / 720.0)
_C8 = _c(1.0 / 40320.0)
_C10 = f32(-1.0 / 3628800.0)
_C12 = f32(1.0 / 479001600.0)


def _sin_poly(y: DS) -> DS:
    y2 = ds_mul(y, y)
    tail = _S11 + y2[0] * _S13
    p = ds_add(_S9, ds_mul_f32(y2, tail))
    p = ds_add(_S7, ds_mul(y2, p))
    p = ds_add(_S5, ds_mul(y2, p))
    p = ds_add(_S3, ds_mul(y2, p))
    return ds_add(y, ds_mul(ds_mul(y, y2), p))


def _cos_poly(y: DS) -> DS:
    y2 = ds_mul(y, y)
    tail = _C10 + y2[0] * _C12
    p = ds_add(_C8, ds_mul_f32(y2, tail))
    p = ds_add(_C6, ds_mul(y2, p))
    p = ds_add(_C4, ds_mul(y2, p))
    p = ds_add(_C2, ds_mul(y2, p))
    one = (torch.ones_like(y[0]), torch.zeros_like(y[0]))
    return ds_add(one, ds_mul(y2, p))


def ds_sin(x: DS) -> DS:
    """sin(x) in ds precision, branch-free, |x| <= ~2^22."""
    k = torch.round(x[0] * _TWO_OVER_PI)
    t1, e1 = two_prod(k, _PIO2_1)
    h = x[0] - t1            # exact by Sterbenz
    t2, e2 = two_prod(k, _PIO2_2)
    y = (h, torch.zeros_like(h))
    y = ds_add_f32(y, -e1)
    y = ds_add_f32(y, x[1])
    y = ds_add_f32(y, -t2)
    y = ds_add_f32(y, -e2)
    y = ds_add_f32(y, -(k * _PIO2_3))

    q = k.to(torch.int32) & 3
    sin_y = _sin_poly(y)
    cos_y = _cos_poly(y)
    use_cos = (q & 1) == 1
    negate = q >= 2
    res = ds_where(use_cos, cos_y, sin_y)
    return ds_where(negate, ds_neg(res), res)


# --- exp: Cody-Waite ln2 reduction + ds-leading Taylor -----------------------

_LN2_1 = f32(0.6931471805599453)
_LN2_2 = f32(0.6931471805599453 - _LN2_1)
_LN2_3 = f32(0.6931471805599453 - _LN2_1 - _LN2_2)
_LOG2E = f32(1.4426950408889634)

_E3 = _c(1.0 / 6.0)
_E4 = _c(1.0 / 24.0)
_E5 = _c(1.0 / 120.0)
_E6 = _c(1.0 / 720.0)
_E7 = _c(1.0 / 5040.0)
_E8 = _c(1.0 / 40320.0)
_E9 = _c(1.0 / 362880.0)
_E10 = f32(1.0 / 3628800.0)
_E11 = f32(1.0 / 39916800.0)
_E12 = f32(1.0 / 479001600.0)


def _exp_poly(r: DS) -> DS:
    """exp(r), requires |r| <= ln2/2 (post-reduction)."""
    tail = _E10 + r[0] * (_E11 + r[0] * _E12)
    p = ds_add(_E9, ds_mul_f32(r, tail))
    p = ds_add(_E8, ds_mul(r, p))
    p = ds_add(_E7, ds_mul(r, p))
    p = ds_add(_E6, ds_mul(r, p))
    p = ds_add(_E5, ds_mul(r, p))
    p = ds_add(_E4, ds_mul(r, p))
    p = ds_add(_E3, ds_mul(r, p))
    half = (torch.full_like(r[0], 0.5), torch.zeros_like(r[0]))
    p = ds_add(half, ds_mul(r, p))
    one = (torch.ones_like(r[0]), torch.zeros_like(r[0]))
    return ds_add(ds_add(one, r), ds_mul(ds_mul(r, r), p))


def ds_exp(x: DS) -> DS:
    """exp(x) in ds precision; results below the float32 normal range
    flush to 0 (the argument range of interest is |x| <= ~88)."""
    k = torch.round(x[0] * _LOG2E)
    t1, e1 = two_prod(k, _LN2_1)
    h = x[0] - t1            # exact by Sterbenz
    t2, e2 = two_prod(k, _LN2_2)
    y = (h, torch.zeros_like(h))
    y = ds_add_f32(y, -e1)
    y = ds_add_f32(y, x[1])
    y = ds_add_f32(y, -t2)
    y = ds_add_f32(y, -e2)
    y = ds_add_f32(y, -(k * _LN2_3))
    e = _exp_poly(y)
    s = pow2_f32(k)          # exact power of two; 0 on deep underflow
    return e[0] * s, e[1] * s
