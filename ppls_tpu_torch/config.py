"""Configuration types of the PyTorch port.

Only the quadrature rule is needed by the walker slice; the run
parameters are keyword arguments of the engine entry points, as in the
reference.
"""

from __future__ import annotations

import enum


class Rule(str, enum.Enum):
    """Quadrature refinement rule.

    TRAPEZOID reproduces the reference C program's semantics: accept
    ``larea + rarea`` when ``|larea + rarea - lrarea| <= eps`` (strict
    ``>`` split test). SIMPSON is composite Simpson with Richardson
    extrapolation.
    """

    TRAPEZOID = "trapezoid"
    SIMPSON = "simpson"
