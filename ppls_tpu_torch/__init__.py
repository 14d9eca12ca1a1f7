"""ppls_tpu_torch: the PyTorch / CUDA port of ppls_tpu for NVIDIA Hopper.

The JAX package ``ppls_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. It carries the flagship family walker
(``integrate_family_walker``, in-kernel or boundary refill, trapezoid or
Simpson, and its many-theta mode ``theta_block`` > 1), the float64
family bag engine (``integrate_family``) and the streaming engine
(``StreamEngine``: requests admitted into family slots and retired one
by one, one walker cycle per phase), each with leg-boundary checkpoints
and kill-and-resume (``resume_family``, ``resume_family_walker``,
``StreamEngine.resume``; ``runtime/checkpoint.py`` keeps the reference's
container, so either package resumes the other's snapshot); the
walk segments run in hand-written CUDA kernels (``csrc/walk_rf.cu``,
``walk_ee.cu``, ``walk_seg.cu``) on the card and in plain PyTorch on the
CPU. Entry points run on CUDA unless ``device="cpu"`` is passed.

No global dtype is set: every tensor is created with an explicit dtype.
"""

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import (
    FAMILIES, family_exact, get_family, get_family_ds)
from ppls_tpu_torch.parallel.bag_engine import (FamilyResult,
                                                integrate_family,
                                                resume_family)
from ppls_tpu_torch.parallel.walker import (
    WalkerResult, integrate_family_walker, resume_family_walker)
from ppls_tpu_torch.runtime.stream import StreamEngine, StreamResult

__all__ = [
    "FAMILIES", "FamilyResult", "Rule", "StreamEngine", "StreamResult",
    "WalkerResult", "family_exact",
    "get_family", "get_family_ds", "integrate_family",
    "integrate_family_walker", "resume_family", "resume_family_walker",
]
