"""Double-single (two-float32) arithmetic on tensors: the host-level ds
library (the reference's XLA-level ``ops/ds.py``).

A value is an unevaluated sum ``hi + lo`` of two float32 tensors with
``|lo| <= ulp(hi)/2``, ~48 mantissa bits. Every function takes and
returns ``(hi, lo)`` tuples of equal-shaped float32 tensors, with the
reference's names, argument order and constants: Dekker/Knuth error-free
transforms, one long-division refinement, the Cody-Waite three-term
pi/2 and ln2 reductions (``_PIO2_1..3``, ``_LN2_1..3``) and ds-leading
Taylor polynomials (``_S*``, ``_C*``, ``_E*``), evaluated in the
reference's order.

The reference fences every error-free transform with a NaN-predicated
select (``_freeze``) because XLA contracts and reassociates across ops.
PyTorch runs each elementwise op eagerly as its own IEEE operation, so
no fence is needed, and the fence-free arithmetic is exactly the walk
kernel's plain library ``ops/ds_kernel.py`` (same operations, same
order): this module takes its transforms, arithmetic, ``ds_sin`` and
``ds_exp`` from there and adds the host-level rest (``ds_const``,
``ds_zero_like``, the comparisons, ``ds_cos``) and the float64
conversions the root-bank deal uses. Results agree bit for bit with the
reference run under ``jax.jit`` on the CPU, except where XLA flushes a
subnormal float32 limb to zero and PyTorch keeps it.

Accuracy (tests/test_torch_ds_lib.py, the reference's tests/test_ds.py
checks): ``ds_sin`` absolute error ~1e-13 over |x| <= 2e4 (~4e-13 at the
worst seeds), ``ds_exp`` relative ~1e-12 over [-50, 5].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ppls_tpu_torch.ops.ds_kernel import (  # noqa: F401 -- the library
    _C2, _C4, _C6, _C8, _C10, _C12, _E3, _E4, _E5, _E6, _E7, _E8, _E9,
    _E10, _E11, _E12, _LN2_1, _LN2_2, _LN2_3, _LOG2E, _PIO2_1, _PIO2_2,
    _PIO2_3, _S3, _S5, _S7, _S9, _S11, _S13, _SPLIT, _TWO_OVER_PI,
    ds_abs, ds_add, ds_add_f32, ds_div, ds_exp, ds_mul, ds_mul_f32,
    ds_mul_pow2, ds_neg, ds_sin, ds_sub, ds_where, quick_two_sum, two_prod,
    two_sum)

DS = Tuple[torch.Tensor, torch.Tensor]


# --- ds construction / destruction ------------------------------------------

def ds_from_f64(x: torch.Tensor) -> DS:
    """Split a float64 tensor into (hi, lo) float32 limbs."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def ds_to_f64(x: DS) -> torch.Tensor:
    """Recombine (hi, lo) limbs to float64."""
    return x[0].to(torch.float64) + x[1].to(torch.float64)


def ds_const(v: float, like: Optional[object] = None) -> DS:
    """ds constant from a Python float (exact split, host-computed),
    broadcast to the shape and device of ``like`` (a tensor or a ds
    pair) when given, else two 0-dim CPU tensors."""
    hi = np.float32(v)
    lo = np.float32(v - float(hi))
    if like is not None:
        ref = like[0] if isinstance(like, tuple) else like
        return (torch.full(ref.shape, float(hi), dtype=torch.float32,
                           device=ref.device),
                torch.full(ref.shape, float(lo), dtype=torch.float32,
                           device=ref.device))
    return (torch.tensor(float(hi), dtype=torch.float32),
            torch.tensor(float(lo), dtype=torch.float32))


def ds_zero_like(x: torch.Tensor) -> DS:
    z = torch.zeros_like(x)
    return z, z


# --- comparisons -------------------------------------------------------------

def ds_lt(x: DS, y: DS) -> torch.Tensor:
    """x < y (exact on the ds representation)."""
    d = ds_sub(x, y)
    return (d[0] < 0) | ((d[0] == 0) & (d[1] < 0))


def ds_gt(x: DS, y: DS) -> torch.Tensor:
    d = ds_sub(x, y)
    return (d[0] > 0) | ((d[0] == 0) & (d[1] > 0))


# --- cos --------------------------------------------------------------------

def ds_cos(x: DS) -> DS:
    """cos(x) = sin(x + pi/2), with pi/2 as its two leading limbs."""
    half_pi = (torch.full_like(x[0], _PIO2_1),
               torch.full_like(x[0], _PIO2_2))
    return ds_sin(ds_add(x, half_pi))
