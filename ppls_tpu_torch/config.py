"""Configuration types of the PyTorch port.

The quadrature rule, the backend selector and the single-integral run
configuration ``QuadConfig`` (the reference C program's problem by
default); the family and walker engines take their run parameters as
keyword arguments, as in the reference.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Rule(str, enum.Enum):
    """Quadrature refinement rule.

    TRAPEZOID reproduces the reference C program's semantics: accept
    ``larea + rarea`` when ``|larea + rarea - lrarea| <= eps`` (strict
    ``>`` split test). SIMPSON is composite Simpson with Richardson
    extrapolation.
    """

    TRAPEZOID = "trapezoid"
    SIMPSON = "simpson"


class Backend(str, enum.Enum):
    """Execution backend selector.

    ``JAX`` keeps the reference's value ``"jax"`` so that the same argv
    (``--backend jax``) runs both packages; in this port it means the
    accelerator path, the engines on the CUDA card (or on the device the
    caller names). ``MPI`` runs the compiled C farmer/worker program
    (``backends/csrc``); ``SPILLOVER`` runs float64 bag rounds on the
    host CPU, where the reference pins that arm too.
    """

    JAX = "jax"
    MPI = "mpi"
    SPILLOVER = "spillover"


@dataclasses.dataclass(frozen=True)
class QuadConfig:
    """Configuration for one adaptive-quadrature run.

    The defaults are the reference problem: cosh^4(x) on [0, 5] with the
    per-interval split tolerance 1e-3. ``eps`` is a local split
    tolerance, not a global error bound.
    """

    integrand: str = "cosh4"
    a: float = 0.0
    b: float = 5.0
    eps: float = 1e-3
    rule: Rule = Rule.TRAPEZOID
    # per-round frontier capacity of the device engine (interval slots)
    capacity: int = 1 << 16
    max_rounds: int = 256
    # host-driven batches are padded to the next power of two >= this
    min_batch: int = 256
    dtype: str = "float64"
    backend: Backend = Backend.JAX
    # multi-chip: number of mesh devices (None = all available)
    n_devices: Optional[int] = None

    def replace(self, **kw) -> "QuadConfig":
        return dataclasses.replace(self, **kw)


# the reference problem (aquadPartA.c:45-48)
REFERENCE_CONFIG = QuadConfig()

# the extended configurations of BASELINE.json
SIN_CONFIG = QuadConfig(integrand="sin", a=0.0, b=1.0, eps=1e-6)
OSC_CONFIG = QuadConfig(integrand="sin_recip", a=1e-4, b=1.0, eps=1e-8,
                        capacity=1 << 20, max_rounds=2048)
OSC_DEEP_CONFIG = OSC_CONFIG.replace(eps=1e-10)
