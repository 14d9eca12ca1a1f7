"""Exact powers of two.

``torch.exp2`` is a polynomial approximation on some backends, and the
walker's dyadic node geometry, ds_exp's final scaling and the
digit-plane reduction's weights all assume exact power-of-two scaling.
These helpers build 2^k from the exponent bits instead.
"""

from __future__ import annotations

import torch


def pow2_f32(k: torch.Tensor) -> torch.Tensor:
    """Exact 2^k (float32) for integer-valued ``k`` in [-126, 127];
    flushes to 0 below (subnormals are not built) and clamps to 2^127
    above."""
    ki = k.to(torch.int32)
    biased = torch.clamp(ki + 127, 1, 254)
    v = (biased << 23).view(torch.float32)
    return torch.where(ki < -126, torch.zeros_like(v), v)


def pow2_f64(k: torch.Tensor) -> torch.Tensor:
    """Exact 2^k (float64) for integer-valued ``k`` in [-252, 252], as
    the product of two exact float32 powers (the same range and
    clamping as the reference)."""
    ki = k.to(torch.int32)
    a = torch.div(ki, 2, rounding_mode="floor")
    b = ki - a
    return (pow2_f32(a).to(torch.float64)
            * pow2_f32(b).to(torch.float64))
