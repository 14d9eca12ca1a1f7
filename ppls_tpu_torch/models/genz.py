"""Genz test-integral families (8D via quasi-Monte-Carlo).

The six canonical Genz families over [0,1]^d, each with a closed-form
integral so the QMC engine reports its achieved error. Difficulty is
set by the affective-dimension vector ``a`` (normalized to a fixed sum
per family, Genz's convention) and the offsets ``u``.

Device side: ``fn(x, a, u)`` maps an (n, d) float64 point block to (n,)
values, elementwise torch with ``a`` and ``u`` as (d,) tensors on the
block's device. Squares are products (the reference's ``** 2`` is a
product; its ``a ** -2`` is ``1 / (a * a)``). Host side: ``exact(a, u)``
uses the ``math`` module.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GenzFamily:
    name: str
    fn: Callable          # fn(x:(n,d), a:(d,), u:(d,)) -> (n,)
    exact: Callable       # exact(a, u) -> float, host math
    difficulty_sum: float  # Genz normalization: sum(a) after scaling
    doc: str = ""


GENZ: Dict[str, GenzFamily] = {}


def _register(name, fn, exact, difficulty_sum, doc=""):
    GENZ[name] = GenzFamily(name, fn, exact, difficulty_sum, doc)


def get_genz(name: str) -> GenzFamily:
    try:
        return GENZ[name]
    except KeyError:
        raise KeyError(f"unknown Genz family {name!r}; registered: "
                       f"{sorted(GENZ)}") from None


def genz_params(name: str, d: int, seed: int = 0):
    """Standard parameter draw: a ~ U(0,1) scaled so sum(a) equals the
    family's difficulty budget; u ~ U(0,1)."""
    rng = np.random.default_rng(seed)
    fam = get_genz(name)
    a = rng.random(d)
    a *= fam.difficulty_sum / a.sum()
    u = rng.random(d)
    return a, u


# --- 1. oscillatory ---------------------------------------------------------

def _osc_fn(x, a, u):
    return torch.cos(2.0 * math.pi * u[0] + x @ a)


def _osc_exact(a, u):
    val = 2.0 * math.pi * float(u[0]) + 0.5 * float(np.sum(a))
    prod = 1.0
    for aj in a:
        prod *= math.sin(aj / 2.0) / (aj / 2.0)
    return math.cos(val) * prod


_register("oscillatory", _osc_fn, _osc_exact, 9.0,
          "cos(2 pi u1 + a.x): global oscillation")


# --- 2. product peak --------------------------------------------------------

def _pp_fn(x, a, u):
    dx = x - u[None, :]
    return torch.prod(1.0 / ((1.0 / (a * a))[None, :] + dx * dx), dim=1)


def _pp_exact(a, u):
    prod = 1.0
    for aj, uj in zip(a, u):
        prod *= aj * (math.atan(aj * (1.0 - uj)) + math.atan(aj * uj))
    return prod


_register("product_peak", _pp_fn, _pp_exact, 7.25,
          "prod 1/(a_j^-2 + (x_j-u_j)^2): interior peaks per axis")


# --- 3. corner peak ---------------------------------------------------------

def _cp_fn(x, a, u):
    d = x.shape[1]
    return torch.pow(1.0 + x @ a, -(d + 1.0))


def _cp_exact(a, u):
    # inclusion-exclusion over the 2^d corners (d=8 -> 256 terms)
    d = len(a)
    total = 0.0
    for v in itertools.product((0, 1), repeat=d):
        s = sum(vj * aj for vj, aj in zip(v, a))
        total += (-1.0) ** sum(v) / (1.0 + s)
    fact = math.factorial(d)
    prod_a = 1.0
    for aj in a:
        prod_a *= aj
    return total / (fact * prod_a)


_register("corner_peak", _cp_fn, _cp_exact, 1.85,
          "(1 + a.x)^-(d+1): single peak at the origin corner")


# --- 4. gaussian ------------------------------------------------------------

def _ga_fn(x, a, u):
    t = a[None, :] * (x - u[None, :])
    return torch.exp(-torch.sum(t * t, dim=1))


def _ga_exact(a, u):
    prod = 1.0
    for aj, uj in zip(a, u):
        prod *= (math.sqrt(math.pi) / (2.0 * aj)) * (
            math.erf(aj * (1.0 - uj)) + math.erf(aj * uj))
    return prod


_register("gaussian", _ga_fn, _ga_exact, 7.03,
          "exp(-sum a_j^2 (x_j-u_j)^2): smooth bump")


# --- 5. continuous (C0) -----------------------------------------------------

def _c0_fn(x, a, u):
    return torch.exp(-torch.sum(a[None, :] * torch.abs(x - u[None, :]),
                                dim=1))


def _c0_exact(a, u):
    prod = 1.0
    for aj, uj in zip(a, u):
        prod *= (2.0 - math.exp(-aj * uj) - math.exp(-aj * (1.0 - uj))) / aj
    return prod


_register("continuous", _c0_fn, _c0_exact, 2.04,
          "exp(-sum a_j |x_j-u_j|): C0 kinks along every axis")


# --- 6. discontinuous -------------------------------------------------------

def _dc_fn(x, a, u):
    inside = (x[:, 0] <= u[0]) & (x[:, 1] <= u[1])
    return torch.where(inside, torch.exp(x @ a), 0.0)


def _dc_exact(a, u):
    prod = 1.0
    for j, aj in enumerate(a):
        hi = u[j] if j < 2 else 1.0
        prod *= (math.exp(aj * hi) - 1.0) / aj
    return prod


_register("discontinuous", _dc_fn, _dc_exact, 4.3,
          "exp(a.x) cut off at (u1, u2): axis-aligned discontinuity")
