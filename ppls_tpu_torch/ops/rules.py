"""Quadrature rules on a batch of intervals (float64).

The adaptive trapezoid test of the reference C worker: whole-interval
trapezoid against the sum of the two half-interval trapezoids, split
when the discrepancy exceeds ``eps`` (strict ``>``), accept the refined
value otherwise. Three distinct integrand evaluations per interval.
Simpson with Richardson extrapolation is the higher-order rule: five
evaluations per interval.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.utils.device import resolve_device

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


def simpson_batch(l: torch.Tensor, r: torch.Tensor, f: Callable,
                  eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse Simpson S1 on [l, r] against composite Simpson S2 on the
    halves: ``err = |S2 - S1| / 15``, and the accepted value is the
    Richardson-extrapolated ``S2 + (S2 - S1) / 15``. The reference's
    float64 operations in its order (a division by a float64 constant
    is a correctly rounded division, as in the reference)."""
    fl = f(l)
    fr = f(r)
    mid = (l + r) * 0.5
    fm = f(mid)
    q1 = (l + mid) * 0.5
    q3 = (mid + r) * 0.5
    fq1 = f(q1)
    fq3 = f(q3)
    h = r - l
    s1 = h / 6.0 * (fl + 4.0 * fm + fr)
    s2 = h / 12.0 * (fl + 4.0 * fq1 + 2.0 * fm + 4.0 * fq3 + fr)
    err = torch.abs(s2 - s1) / 15.0
    value = s2 + (s2 - s1) / 15.0
    split = err > eps
    return value, err, split


_RULES = {Rule.TRAPEZOID: trapezoid_batch, Rule.SIMPSON: simpson_batch}


def eval_batch(l: torch.Tensor, r: torch.Tensor, f: Callable, eps: float,
               rule: Rule = Rule.TRAPEZOID
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a batch of intervals: ``(value, err_est, split_mask)``."""
    return _RULES[Rule(rule)](l, r, f, eps)


def eval_interval(l: float, r: float, f: Callable, eps: float,
                  rule: Rule = Rule.TRAPEZOID, device="cuda"):
    """:func:`eval_batch` on one interval (0-dim float64 tensors on
    ``device``: CUDA by default, raising without a card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    return eval_batch(torch.tensor(float(l), dtype=torch.float64,
                                   device=dev),
                      torch.tensor(float(r), dtype=torch.float64,
                                   device=dev), f, eps, rule)
