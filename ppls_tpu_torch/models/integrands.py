"""Integrand families of the port: ``f(x, theta)`` in float64, their
double-single twins for the walk kernel, domain checks, and closed
forms.

Two families are carried: ``sin_recip_scaled`` (sin(theta / x), the
flagship bench family) and ``cosh4_scaled`` (cosh^4(theta x); theta = 1
over [0, 5] is the reference C program's problem). Each ds twin names
the integrand the CUDA walk kernel compiles in (``kernel_family``),
matching the ``FAMILY_*`` ids of ``csrc/walk_step.cuh``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

FAMILIES: Dict[str, Callable] = {}
DS_FAMILIES: Dict[str, Callable] = {}
FAMILY_EXACT_VEC: Dict[str, Callable] = {}

# Cody-Waite validity limits of the ds transcendentals: beyond these the
# range reduction returns silently wrong values, not NaNs.
DS_SIN_MAX_ARG = float(1 << 22)
# cosh^4 must stay inside the float32 hi limb: |u| <= 22 keeps margin.
DS_COSH4_MAX_ARG = 22.0

# kernel integrand ids (csrc/walk_step.cuh FAMILY_SIN_RECIP / FAMILY_COSH4)
KERNEL_SIN_RECIP = 0
KERNEL_COSH4 = 1


def get_family(name: str) -> Callable:
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown family {name!r}; registered: "
                       f"{sorted(FAMILIES)}") from None


def get_family_ds(name: str) -> Callable:
    try:
        return DS_FAMILIES[name]
    except KeyError:
        raise KeyError(f"no ds twin for family {name!r}; registered: "
                       f"{sorted(DS_FAMILIES)}") from None


def _sin_recip_scaled(x: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    return torch.sin(th / x)


def _cosh4_scaled(x: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    c = torch.cosh(th * x)
    c2 = c * c
    return c2 * c2


FAMILIES["sin_recip_scaled"] = _sin_recip_scaled
FAMILIES["cosh4_scaled"] = _cosh4_scaled


def _sin_recip_scaled_ds(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    return dsm.ds_sin(dsm.ds_div(th, x))


def _cosh4_scaled_ds(x, th, dsm=None):
    # cosh(u) = (e^u + e^-u) / 2, then two squarings
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    u = dsm.ds_mul(th, x)
    e = dsm.ds_exp(u)
    one = (torch.ones_like(e[0]), torch.zeros_like(e[0]))
    inv = dsm.ds_div(one, e)
    c = dsm.ds_mul_pow2(dsm.ds_add(e, inv), 0.5)
    c2 = dsm.ds_mul(c, c)
    return dsm.ds_mul(c2, c2)


def _sin_recip_domain(bounds: np.ndarray, theta: np.ndarray) -> None:
    if np.any(bounds <= 0.0):
        raise ValueError(
            "sin_recip_scaled ds twin requires bounds > 0 (theta/x pole)")
    worst = np.max(np.abs(theta) / np.min(bounds, axis=1))
    if worst > DS_SIN_MAX_ARG:
        raise ValueError(
            f"sin_recip_scaled ds twin out of ds_sin's Cody-Waite range: "
            f"max |theta/x| = {worst:.3e} > {DS_SIN_MAX_ARG:.3e} "
            f"(results would be silently wrong, not NaN)")


def _cosh4_scaled_domain(bounds: np.ndarray, theta: np.ndarray) -> None:
    worst = np.max(np.abs(theta) * np.max(np.abs(bounds), axis=1))
    if worst > DS_COSH4_MAX_ARG:
        raise ValueError(
            f"cosh4_scaled ds twin out of range: max |theta*x| = "
            f"{worst:.3e} > {DS_COSH4_MAX_ARG} (cosh^4 would overflow "
            f"the float32 hi limb)")


_sin_recip_scaled_ds.ds_domain_check = _sin_recip_domain
_sin_recip_scaled_ds.kernel_family = KERNEL_SIN_RECIP
_cosh4_scaled_ds.ds_domain_check = _cosh4_scaled_domain
_cosh4_scaled_ds.kernel_family = KERNEL_COSH4
DS_FAMILIES["sin_recip_scaled"] = _sin_recip_scaled_ds
DS_FAMILIES["cosh4_scaled"] = _cosh4_scaled_ds


def check_ds_domain(f_ds: Callable, bounds, theta) -> None:
    """Run a ds twin's domain validator, if it has one."""
    check = getattr(f_ds, "ds_domain_check", None)
    if check is not None:
        check(np.asarray(bounds, dtype=np.float64).reshape(-1, 2),
              np.asarray(theta, dtype=np.float64).reshape(-1))


# --- closed forms (numpy / scipy, host side) ---------------------------------

def _sin_recip_scaled_exact_vec(a, b, th):
    # int sin(th/x) dx = x sin(th/x) - th Ci(th/x)
    from scipy import special
    th = np.asarray(th, dtype=np.float64)
    _si_a, ci_a = special.sici(th / a)
    _si_b, ci_b = special.sici(th / b)

    def F(x, ci):
        return x * np.sin(th / x) - th * ci

    return F(np.float64(b), ci_b) - F(np.float64(a), ci_a)


def _cosh4_scaled_exact_vec(a, b, th):
    th = np.asarray(th, dtype=np.float64)
    safe = np.where(th == 0.0, 1.0, th)

    def F(x):
        u = safe * x
        return (3.0 * u / 8.0 + np.sinh(2.0 * u) / 4.0
                + np.sinh(4.0 * u) / 32.0) / safe

    return np.where(th == 0.0, b - a, F(b) - F(a))


FAMILY_EXACT_VEC["sin_recip_scaled"] = _sin_recip_scaled_exact_vec
FAMILY_EXACT_VEC["cosh4_scaled"] = _cosh4_scaled_exact_vec


def family_exact(name: str, a: float, b: float, theta) -> Optional[np.ndarray]:
    """Exact integrals over [a, b] for every theta (float64 array of
    theta's shape), or None if the family has no closed form."""
    vfn = FAMILY_EXACT_VEC.get(name)
    if vfn is None:
        return None
    th = np.asarray(theta, dtype=np.float64)
    return np.asarray(vfn(float(a), float(b), th.reshape(-1)),
                      dtype=np.float64).reshape(th.shape)
