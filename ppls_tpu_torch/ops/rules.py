"""Quadrature rules on a batch of intervals (float64).

The adaptive trapezoid test of the reference C worker: whole-interval
trapezoid against the sum of the two half-interval trapezoids, split
when the discrepancy exceeds ``eps`` (strict ``>``), accept the refined
value otherwise. Three distinct integrand evaluations per interval.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ppls_tpu_torch.config import Rule

EVALS_PER_TASK = {Rule.TRAPEZOID: 3, Rule.SIMPSON: 5}


def trapezoid_batch(l: torch.Tensor, r: torch.Tensor, f: Callable,
                    eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(value, err, split)``: the refined value (meaningful
    where ``split`` is False), the discrepancy, and the split mask."""
    fl = f(l)
    fr = f(r)
    mid = (l + r) * 0.5
    fm = f(mid)
    lrarea = (fl + fr) * (r - l) * 0.5
    larea = (fl + fm) * (mid - l) * 0.5
    rarea = (fm + fr) * (r - mid) * 0.5
    value = larea + rarea
    err = torch.abs(value - lrarea)
    split = err > eps
    return value, err, split


def eval_batch(l: torch.Tensor, r: torch.Tensor, f: Callable, eps: float,
               rule: Rule = Rule.TRAPEZOID
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a batch of intervals: ``(value, err_est, split_mask)``."""
    if Rule(rule) != Rule.TRAPEZOID:
        raise NotImplementedError(
            "Rule.SIMPSON is not ported yet (ROADMAP Queue 2, K1 Simpson "
            "mode)")
    return trapezoid_batch(l, r, f, eps)
