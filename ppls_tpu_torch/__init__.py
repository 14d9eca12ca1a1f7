"""ppls_tpu_torch: the PyTorch / CUDA port of ppls_tpu for NVIDIA Hopper.

The JAX package ``ppls_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. This slice carries the flagship
family walker (``integrate_family_walker``) and the float64 family bag
engine (``integrate_family``); the walk segment runs in a hand-written
CUDA kernel (``csrc/walk_rf.cu``) on the card and in plain PyTorch on
the CPU. Entry points run on CUDA unless ``device="cpu"`` is passed.

No global dtype is set: every tensor is created with an explicit dtype.
"""

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import (
    FAMILIES, family_exact, get_family, get_family_ds)
from ppls_tpu_torch.parallel.bag_engine import FamilyResult, integrate_family
from ppls_tpu_torch.parallel.walker import (
    WalkerResult, integrate_family_walker)

__all__ = [
    "FAMILIES", "FamilyResult", "Rule", "WalkerResult", "family_exact",
    "get_family", "get_family_ds", "integrate_family",
    "integrate_family_walker",
]
