"""Integrands of the port: the single-integrand registry (``f(x)`` in
float64 with a host antiderivative: ``INTEGRANDS``, ``get_integrand``),
the families ``f(x, theta)`` in float64 with their double-single
twins for the walk kernel, domain checks, and closed forms, and the 2D
integrands ``f(x, y)`` of the cubature engine (``INTEGRANDS_2D``,
``get_integrand_2d``: ``gauss2d_peak``, ``gauss2d_ring``, ``cos_prod``,
``poly_xy``).

The single integrands: ``cosh4`` (the reference C program's problem),
``sin``, ``sin_recip`` (sin(1/x), whose antiderivative needs the cosine
integral: ``scipy.special.sici``), ``gauss_peak``, ``poly3``, ``exp``
and ``runge``.

The families: ``sin_recip_scaled`` (sin(theta / x), the flagship bench
family), ``sin_scaled`` (sin(theta x), the many-theta walker's bench
family), ``cosh4_scaled`` (cosh^4(theta x); theta = 1 over [0, 5] is the
reference C program's problem), ``gauss_center`` (a Gaussian of width
1e-3 centred at theta: the clustered-refinement stress case) and
``quad_scaled`` (theta x^2, dyadic-exact: on dyadic bounds every credit
and sum is exact, so areas do not depend on the schedule).

Each family has a ds twin (``DS_FAMILIES``); the three transcendental
families also have a range-reduced twin (``DS_FAMILIES_REDUCED``:
cosh^4 through one exp of 2|u|, sin through ``ds_sin_pi``), chosen with
``get_family_ds(name, reduced=True)``. Every twin names the integrand
the CUDA walk kernels compile in (``kernel_family``), matching the
``FAMILY_*`` ids of ``csrc/walk_step.cuh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ppls_tpu_torch.ops.rules2d import div

FAMILIES: Dict[str, Callable] = {}
DS_FAMILIES: Dict[str, Callable] = {}
DS_FAMILIES_REDUCED: Dict[str, Callable] = {}
# closed forms: per-theta exact(a, b, theta) -> float (user families;
# the built-ins register none, see family_exact) and vectorised
# exact_vec(a, b, theta[]) -> float64 ndarray
FAMILY_EXACT: Dict[str, Callable] = {}
FAMILY_EXACT_VEC: Dict[str, Callable] = {}

# Cody-Waite validity limits of the ds transcendentals: beyond these the
# range reduction returns silently wrong values, not NaNs.
DS_SIN_MAX_ARG = float(1 << 22)
DS_EXP_MAX_ARG = 88.0
# cosh^4 must stay inside the float32 hi limb: |u| <= 22 keeps margin
# (the reduced form's exp(2|u|) <= exp(44) is finite there too).
DS_COSH4_MAX_ARG = 22.0

# kernel integrand ids (csrc/walk_step.cuh FAMILY_*), one per ds twin
KERNEL_SIN_RECIP = 0
KERNEL_COSH4 = 1
KERNEL_SIN_SCALED = 2
KERNEL_QUAD_SCALED = 3
KERNEL_GAUSS_CENTER = 4
KERNEL_SIN_RECIP_REDUCED = 5
KERNEL_COSH4_REDUCED = 6
KERNEL_SIN_SCALED_REDUCED = 7


@dataclasses.dataclass(frozen=True)
class Integrand:
    """One registered integrand: ``fn`` maps a float64 tensor to a
    float64 tensor elementwise; ``antiderivative`` is a host ``math``
    function (F' = f), or None."""

    name: str
    fn: Callable
    antiderivative: Optional[Callable] = None
    doc: str = ""

    def exact(self, a: float, b: float) -> Optional[float]:
        """Closed-form integral over [a, b], or None if unknown."""
        if self.antiderivative is None:
            return None
        return float(self.antiderivative(float(b))
                     - self.antiderivative(float(a)))


INTEGRANDS: Dict[str, Integrand] = {}


def register_integrand(name: str, fn: Callable,
                       antiderivative: Optional[Callable] = None,
                       doc: str = "") -> Integrand:
    entry = Integrand(name=name, fn=fn, antiderivative=antiderivative,
                      doc=doc)
    INTEGRANDS[name] = entry
    return entry


def get_integrand(name: str) -> Integrand:
    try:
        return INTEGRANDS[name]
    except KeyError:
        raise KeyError(
            f"unknown integrand {name!r}; registered: {sorted(INTEGRANDS)}"
        ) from None


def _cosh4(x: torch.Tensor) -> torch.Tensor:
    c = torch.cosh(x)
    c2 = c * c
    return c2 * c2


def _cosh4_anti(x: float) -> float:
    # int cosh^4 x dx = 3x/8 + sinh(2x)/4 + sinh(4x)/32
    return 3.0 * x / 8.0 + math.sinh(2.0 * x) / 4.0 + math.sinh(4.0 * x) / 32.0


def _sin_recip_anti(x: float) -> float:
    # int sin(1/x) dx = x sin(1/x) - Ci(1/x) for x > 0, with limit 0 at
    # x -> 0+
    if x < 0:
        raise ValueError("sin_recip antiderivative defined for x >= 0")
    if x == 0:
        return 0.0
    from scipy import special
    _si, ci = special.sici(1.0 / x)
    return float(x * math.sin(1.0 / x) - ci)


def _gauss_peak(x: torch.Tensor) -> torch.Tensor:
    # sigma 1e-3 at 0.5; the divisor is a tensor on x's device (see
    # gauss_center below)
    return torch.exp(-0.5 * ((x - 0.5) / x.new_tensor(1e-3)) ** 2)


def _gauss_peak_anti(x: float) -> float:
    s = 1e-3
    return s * math.sqrt(math.pi / 2.0) * math.erf(
        (x - 0.5) / (s * math.sqrt(2.0)))


register_integrand(
    "cosh4", _cosh4, _cosh4_anti,
    doc="The reference problem: cosh^4(x); exact integral over [0, 5] = "
        "7583461.361497.")
register_integrand("sin", torch.sin, lambda x: -math.cos(x),
                   doc="sin(x) on [0, 1], eps 1e-6 (BASELINE.json).")
register_integrand(
    "sin_recip", lambda x: torch.sin(1.0 / x), _sin_recip_anti,
    doc="sin(1/x) on [1e-4, 1] (BASELINE.json): deep splitting near the "
        "left end.")
register_integrand("gauss_peak", _gauss_peak, _gauss_peak_anti,
                   doc="Gaussian of width 1e-3 at 0.5: clustered "
                       "refinement.")
register_integrand("poly3", lambda x: x * x * x, lambda x: 0.25 * x ** 4,
                   doc="x^3: Simpson integrates it exactly.")
register_integrand("exp", torch.exp, math.exp, doc="exp(x).")
register_integrand("runge", lambda x: 1.0 / (1.0 + 25.0 * x * x),
                   lambda x: math.atan(5.0 * x) / 5.0,
                   doc="The Runge function on [-1, 1].")


def register_family(name: str, f_theta: Callable) -> Callable:
    """Register a parameterised integrand ``f(x, theta)`` (float64
    tensors) for family runs."""
    FAMILIES[name] = f_theta
    return f_theta


def register_family_ds(name: str, f_ds: Callable,
                       domain_check: Optional[Callable] = None) -> Callable:
    """Register the ds twin of a family: ``f_ds(x_ds, theta_ds,
    dsm=None)`` on (hi, lo) float32 pairs (scouting passes
    ``dsm=ops.scout_kernel``).

    ``domain_check(bounds, theta)`` (host side; ``bounds`` (m, 2),
    ``theta`` (m,)) must raise ``ValueError`` where a ds transcendental
    would leave its Cody-Waite range; it is attached as
    ``f_ds.ds_domain_check``. The CUDA kernels compile their integrands
    in, so a twin registered here runs on the CPU (and in the float64
    modes, which evaluate no twin); without a ``kernel_family`` id a
    kernel launch on the card raises."""
    if domain_check is not None:
        f_ds.ds_domain_check = domain_check
    DS_FAMILIES[name] = f_ds
    return f_ds


def get_family(name: str) -> Callable:
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown family {name!r}; registered: "
                       f"{sorted(FAMILIES)}") from None


def family_name_of(f_theta: Callable) -> Optional[str]:
    """The registered name of a family callable, None for an ad-hoc
    one. The walker's tuning-table signature needs the name; an
    unregistered integrand resolves through the hand-default tier."""
    for name, fn in FAMILIES.items():
        if fn is f_theta:
            return name
    return None


def register_family_ds_reduced(name: str, f_ds: Callable,
                               domain_check: Optional[Callable] = None
                               ) -> Callable:
    """Register the range-reduced ds twin of a family: the contract of
    :func:`register_family_ds`, chosen only by ``get_family_ds(name,
    reduced=True)``."""
    if domain_check is not None:
        f_ds.ds_domain_check = domain_check
    DS_FAMILIES_REDUCED[name] = f_ds
    return f_ds


def get_family_ds(name: str, reduced: bool = False) -> Callable:
    """A family's ds twin. With ``reduced``, its range-reduced twin where
    it has one, else its ds twin: the flag picks a cheaper evaluation,
    never which families exist."""
    if reduced and name in DS_FAMILIES_REDUCED:
        return DS_FAMILIES_REDUCED[name]
    try:
        return DS_FAMILIES[name]
    except KeyError:
        raise KeyError(f"no ds twin for family {name!r}; registered: "
                       f"{sorted(DS_FAMILIES)}") from None


def _cosh4_scaled(x: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    c = torch.cosh(th * x)
    c2 = c * c
    return c2 * c2


def _quad_scaled(x: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    return th * x * x


# registered as the reference registers them, lambdas among them: a
# snapshot's identity names the integrand by its ``__name__``, so a
# snapshot of one package resumes in the other
register_family("sin_recip_scaled", lambda x, s: torch.sin(s / x))
register_family("sin_scaled", lambda x, s: torch.sin(s * x))
# the divisor is a tensor on x's device: PyTorch on CUDA multiplies by the
# reciprocal of a Python-scalar divisor, on the CPU it divides
register_family("gauss_center", lambda x, c: torch.exp(
    -0.5 * ((x - c) / x.new_tensor(1e-3)) ** 2))
FAMILIES["cosh4_scaled"] = _cosh4_scaled
FAMILIES["quad_scaled"] = _quad_scaled


def _sin_recip_scaled_ds(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    return dsm.ds_sin(dsm.ds_div(th, x))


def _sin_scaled_ds(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    return dsm.ds_sin(dsm.ds_mul(th, x))


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


def _quad_scaled_ds(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    return dsm.ds_mul(th, dsm.ds_mul(x, x))


def _gauss_center_ds(x, c, dsm=None):
    # exp(-0.5 ((x - c) / 1e-3)^2) = exp(-500000 (x - c)^2); the scale is
    # an integer below 2^24, exact in float32
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    d = dsm.ds_sub(x, c)
    z = dsm.ds_mul_f32(dsm.ds_mul(d, d), -500000.0)
    return dsm.ds_exp(z)


# The range-reduced twins. cosh^4(u) = ((1 + cosh 2u) / 2)^2 with
# cosh 2u = (E + 1/E) / 2 at E = exp(2|u|): one exp, one division and
# one squaring where the reference form takes an exp, a division and two
# squarings; the even symmetry keeps E >= 1. sin through the pi-reduced
# one-polynomial ds_sin_pi; a ds module without it uses its ds_sin.


def _cosh4_scaled_ds_reduced(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    u = dsm.ds_mul(th, x)
    au = dsm.ds_abs(u)
    e2 = dsm.ds_exp(dsm.ds_mul_pow2(au, 2.0))
    one = (torch.ones_like(e2[0]), torch.zeros_like(e2[0]))
    inv = dsm.ds_div(one, e2)
    c2u = dsm.ds_mul_pow2(dsm.ds_add(e2, inv), 0.5)
    half = dsm.ds_mul_pow2(dsm.ds_add(one, c2u), 0.5)
    return dsm.ds_mul(half, half)


def _sin_recip_scaled_ds_reduced(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    sin_fn = getattr(dsm, "ds_sin_pi", dsm.ds_sin)
    return sin_fn(dsm.ds_div(th, x))


def _sin_scaled_ds_reduced(x, th, dsm=None):
    if dsm is None:
        from ppls_tpu_torch.ops import ds_kernel as dsm
    sin_fn = getattr(dsm, "ds_sin_pi", dsm.ds_sin)
    return sin_fn(dsm.ds_mul(th, x))


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


def _sin_scaled_domain(bounds: np.ndarray, theta: np.ndarray) -> None:
    worst = np.max(np.abs(theta) * np.max(np.abs(bounds), axis=1))
    if worst > DS_SIN_MAX_ARG:
        raise ValueError(
            f"sin_scaled ds twin out of ds_sin's Cody-Waite range: "
            f"max |theta*x| = {worst:.3e} > {DS_SIN_MAX_ARG:.3e} "
            f"(results would be silently wrong, not NaN)")


def _cosh4_scaled_domain(bounds: np.ndarray, theta: np.ndarray) -> None:
    worst = np.max(np.abs(theta) * np.max(np.abs(bounds), axis=1))
    if worst > DS_COSH4_MAX_ARG:
        raise ValueError(
            f"cosh4_scaled ds twin out of range: max |theta*x| = "
            f"{worst:.3e} > {DS_COSH4_MAX_ARG} (cosh^4 would overflow "
            f"the float32 hi limb)")


_sin_recip_scaled_ds.kernel_family = KERNEL_SIN_RECIP
_sin_scaled_ds.kernel_family = KERNEL_SIN_SCALED
_cosh4_scaled_ds.kernel_family = KERNEL_COSH4
_quad_scaled_ds.kernel_family = KERNEL_QUAD_SCALED
_gauss_center_ds.kernel_family = KERNEL_GAUSS_CENTER
_sin_recip_scaled_ds_reduced.kernel_family = KERNEL_SIN_RECIP_REDUCED
_cosh4_scaled_ds_reduced.kernel_family = KERNEL_COSH4_REDUCED
_sin_scaled_ds_reduced.kernel_family = KERNEL_SIN_SCALED_REDUCED
register_family_ds("sin_recip_scaled", _sin_recip_scaled_ds,
                   domain_check=_sin_recip_domain)
register_family_ds("sin_scaled", _sin_scaled_ds,
                   domain_check=_sin_scaled_domain)
# gauss_center: -500000 (x - c)^2 <= 0, and ds_exp underflows to exactly
# 0 (the limit) for large negative arguments; quad_scaled multiplies only.
# Every (bounds, theta) is in their domain.
register_family_ds("gauss_center", _gauss_center_ds)
register_family_ds("cosh4_scaled", _cosh4_scaled_ds,
                   domain_check=_cosh4_scaled_domain)
register_family_ds("quad_scaled", _quad_scaled_ds)
# the reduced twins carry their families' domain checks
register_family_ds_reduced("cosh4_scaled", _cosh4_scaled_ds_reduced,
                           domain_check=_cosh4_scaled_domain)
register_family_ds_reduced("sin_recip_scaled", _sin_recip_scaled_ds_reduced,
                           domain_check=_sin_recip_domain)
register_family_ds_reduced("sin_scaled", _sin_scaled_ds_reduced,
                           domain_check=_sin_scaled_domain)


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


def _sin_scaled_exact_vec(a, b, th):
    th = np.asarray(th, dtype=np.float64)
    safe = np.where(th == 0.0, 1.0, th)
    out = (np.cos(safe * a) - np.cos(safe * b)) / safe
    # theta -> 0: the integrand vanishes, and so does the integral
    return np.where(th == 0.0, 0.0, out)


def _cosh4_scaled_exact_vec(a, b, th):
    th = np.asarray(th, dtype=np.float64)
    safe = np.where(th == 0.0, 1.0, th)

    def F(x):
        u = safe * x
        return (3.0 * u / 8.0 + np.sinh(2.0 * u) / 4.0
                + np.sinh(4.0 * u) / 32.0) / safe

    return np.where(th == 0.0, b - a, F(b) - F(a))


def _gauss_center_exact_vec(a, b, c):
    from scipy import special
    c = np.asarray(c, dtype=np.float64)
    s = 1e-3

    def g(x):
        return s * np.sqrt(np.pi / 2.0) * special.erf(
            (x - c) / (s * np.sqrt(2.0)))

    return g(np.float64(b)) - g(np.float64(a))


def _quad_scaled_exact_vec(a, b, th):
    th = np.asarray(th, dtype=np.float64)
    return th * (np.float64(b) ** 3 - np.float64(a) ** 3) / 3.0


FAMILY_EXACT_VEC["sin_recip_scaled"] = _sin_recip_scaled_exact_vec
FAMILY_EXACT_VEC["sin_scaled"] = _sin_scaled_exact_vec
FAMILY_EXACT_VEC["cosh4_scaled"] = _cosh4_scaled_exact_vec
FAMILY_EXACT_VEC["gauss_center"] = _gauss_center_exact_vec
FAMILY_EXACT_VEC["quad_scaled"] = _quad_scaled_exact_vec


def register_family_exact(name: str, fn: Callable,
                          vec: Optional[Callable] = None) -> Callable:
    """Register exact(a, b, theta) -> float for a parameterised family,
    plus an optional vectorised numpy twin exact_vec(a, b, theta[])."""
    FAMILY_EXACT[name] = fn
    if vec is not None:
        FAMILY_EXACT_VEC[name] = vec
    return fn


def family_exact(name: str, a: float, b: float, theta,
                 prefer_vec: Optional[bool] = None) -> Optional[np.ndarray]:
    """Exact integrals over [a, b] for every theta (float64 array of
    theta's shape), or None if the family has no closed form.

    The vectorised form answers when one is registered and
    ``prefer_vec`` is true (by default: 64 thetas or more) or no
    per-theta form is registered; otherwise the per-theta form, one call
    a theta. The built-in families register only vectorised forms (the
    reference's per-theta forms are 40-digit mpmath)."""
    fn = FAMILY_EXACT.get(name)
    vfn = FAMILY_EXACT_VEC.get(name)
    if fn is None and vfn is None:
        return None
    th = np.asarray(theta, dtype=np.float64)
    if prefer_vec is None:
        prefer_vec = th.size >= 64
    if vfn is not None and (prefer_vec or fn is None):
        return np.asarray(vfn(float(a), float(b), th.reshape(-1)),
                          dtype=np.float64).reshape(th.shape)
    return np.array([fn(float(a), float(b), float(t))
                     for t in th.reshape(-1)],
                    dtype=np.float64).reshape(th.shape)


# --- float64 models of the reduced forms (host side, numpy) ------------------
# Each reduced form evaluated in plain float64, held to the reference
# integrand's float64 values by the ulp protocol of the reference's tests
# (tests/test_reduced_integrands.py).


def cosh4_scaled_reduced_f64(x, th):
    """The reduced cosh^4 form in float64: ((1 + cosh(2|u|)) / 2)^2."""
    u = np.abs(np.asarray(x, dtype=np.float64) * np.float64(th))
    return ((1.0 + np.cosh(2.0 * u)) * 0.5) ** 2


def _two_prod_f64(a, b):
    """Dekker product in float64 (splitter 2^27 + 1): p + e == a * b
    exactly."""
    split = np.float64(134217729.0)
    p = a * b
    ta = split * a
    ah = ta - (ta - a)
    al = a - ah
    tb = split * b
    bh = tb - (tb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def sin_recip_scaled_reduced_f64(x, th):
    """The pi-reduced sin(theta / x) in float64: the argument mod pi by a
    two-limb pi subtraction with an exact Dekker product, one sin on
    [-pi/2, pi/2], the parity sign."""
    arg = np.float64(th) / np.asarray(x, dtype=np.float64)
    k = np.round(arg / np.pi)
    p1 = np.float64(3.141592653589793)
    pl = np.float64(1.2246467991473532e-16)
    t, e = _two_prod_f64(k, p1)
    y = (arg - t) - (e + k * pl)   # arg - t exact by Sterbenz
    s = np.sin(y)
    return np.where((k.astype(np.int64) & 1) == 1, -s, s)


# --- 2D integrands (adaptive tensor-product cubature; consumed by
# parallel.cubature.integrate_2d) -------------------------------------------
# ``fn(x, y)`` is elementwise float64 torch; ``exact`` is host ``math``.
# Squares are products (the reference's ``** 2`` is a product), and a
# division by a constant divides by a tensor on the operands' device.

@dataclasses.dataclass(frozen=True)
class Integrand2D:
    name: str
    fn: Callable                      # f(x, y) -> z, elementwise
    exact: Optional[Callable] = None  # exact(ax, bx, ay, by) -> float
    doc: str = ""


INTEGRANDS_2D: Dict[str, Integrand2D] = {}


def register_integrand_2d(name: str, fn: Callable,
                          exact: Optional[Callable] = None,
                          doc: str = "") -> Integrand2D:
    entry = Integrand2D(name=name, fn=fn, exact=exact, doc=doc)
    INTEGRANDS_2D[name] = entry
    return entry


def get_integrand_2d(name: str) -> Integrand2D:
    try:
        return INTEGRANDS_2D[name]
    except KeyError:
        raise KeyError(
            f"unknown 2D integrand {name!r}; registered: "
            f"{sorted(INTEGRANDS_2D)}") from None


_G2_S = 0.05  # gauss2d_peak sigma


def _gauss2d(x, y):
    dx = div(x - 0.5, _G2_S)
    dy = div(y - 0.5, _G2_S)
    return torch.exp(-0.5 * (dx * dx + dy * dy))


def _gauss2d_exact(ax, bx, ay, by):
    # separable: product of 1D Gaussian integrals (erf closed form)
    def g1(a, b):
        s = _G2_S
        return s * math.sqrt(math.pi / 2.0) * (
            math.erf((b - 0.5) / (s * math.sqrt(2.0)))
            - math.erf((a - 0.5) / (s * math.sqrt(2.0))))
    return g1(ax, bx) * g1(ay, by)


register_integrand_2d(
    "gauss2d_peak", _gauss2d, _gauss2d_exact,
    doc="Sharply peaked 2D Gaussian at (0.5, 0.5), sigma=0.05: the "
        "clustered-refinement stress case.")

_G2R_S = 0.05    # gauss2d_ring ridge width
_G2R_R0 = 0.3    # gauss2d_ring radius


def _gauss2d_ring(x, y):
    dx = x - 0.5
    dy = y - 0.5
    r = torch.sqrt(dx * dx + dy * dy)
    u = div(r - _G2R_R0, _G2R_S)
    return torch.exp(-(u * u))


def _gauss2d_ring_exact(ax, bx, ay, by):
    # Polar closed form over the plane: 2*pi * int_0^inf r *
    # exp(-((r - r0)/s)^2) dr = 2*pi * (s*r0*(sqrt(pi)/2)*(1 +
    # erf(r0/s)) + (s^2/2)*exp(-(r0/s)^2)). Valid for the standard
    # [0,1]^2 domain: the ridge sits >= 4 sigma inside it, so the
    # truncated tail mass is < 3e-9 absolute (erfc(4) bound).
    if (ax, bx, ay, by) != (0.0, 1.0, 0.0, 1.0):
        raise ValueError("gauss2d_ring's closed form assumes the "
                         "standard [0,1]^2 domain (ridge well inside)")
    s, r0 = _G2R_S, _G2R_R0
    q = r0 / s
    return 2.0 * math.pi * (
        s * r0 * (math.sqrt(math.pi) / 2.0) * (1.0 + math.erf(q))
        + 0.5 * s * s * math.exp(-q * q))


register_integrand_2d(
    "gauss2d_ring", _gauss2d_ring, _gauss2d_ring_exact,
    doc="Gaussian ridge along the circle r=0.3 (width sigma=0.05): "
        "refinement hugs a 1D curve, so the cell count scales like "
        "curve-length/h (~6M cells at eps=1e-12). C twin: "
        "backends/csrc/aquad_seq.c 2d mode, fid2=1.")

register_integrand_2d(
    "cos_prod", lambda x, y: torch.cos(x) * torch.cos(y),
    lambda ax, bx, ay, by: ((math.sin(bx) - math.sin(ax))
                            * (math.sin(by) - math.sin(ay))),
    doc="cos(x)cos(y): smooth separable benchmark with closed form.")

register_integrand_2d(
    "poly_xy", lambda x, y: x * x * y + x * y * y,
    lambda ax, bx, ay, by: (
        (bx ** 3 - ax ** 3) / 3.0 * (by ** 2 - ay ** 2) / 2.0
        + (bx ** 2 - ax ** 2) / 2.0 * (by ** 3 - ay ** 3) / 3.0),
    doc="x^2 y + x y^2: low-order polynomial sanity check.")
