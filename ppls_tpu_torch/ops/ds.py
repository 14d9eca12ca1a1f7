"""Host-level double-single helpers: split float64 into (hi, lo)
float32 limbs and recombine.

PyTorch runs eagerly and never reassociates or contracts across ops, so
the error-free transforms of ``ops/ds_kernel.py`` hold as written and
this module needs none of the NaN fences the XLA-level reference
library carries. Only the conversions the root-bank deal uses live here.
"""

from __future__ import annotations

from typing import Tuple

import torch

DS = Tuple[torch.Tensor, torch.Tensor]


def ds_from_f64(x: torch.Tensor) -> DS:
    """Split a float64 tensor into (hi, lo) float32 limbs."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def ds_to_f64(x: DS) -> torch.Tensor:
    """Recombine (hi, lo) limbs to float64."""
    return x[0].to(torch.float64) + x[1].to(torch.float64)
