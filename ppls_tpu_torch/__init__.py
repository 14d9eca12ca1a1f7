"""ppls_tpu_torch: the PyTorch / CUDA port of ppls_tpu for NVIDIA Hopper.

The JAX package ``ppls_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. It carries the single-integral API
(``QuadConfig``, the host-driven wavefront ``integrate`` and the
device-resident ``device_integrate``, the integrand registry
``get_integrand``/``register_integrand``/``INTEGRANDS``, the rules
``eval_batch``/``eval_interval``, the backends of ``backends/``), the
flagship family walker (``integrate_family_walker``, in-kernel or
boundary refill, trapezoid or Simpson, and its many-theta mode
``theta_block`` > 1), the float64 family bag engine
(``integrate_family``) and the streaming engine (``StreamEngine``:
requests admitted into family slots and retired one by one, one walker
cycle per phase, queue-overflow victims optionally run on the CPU
spillover backend; with ``engine="walker-dd"`` across ranks that live
as long as the engine) and the pool dispatcher in front of it
(``EngineDispatcher``: one stream engine per (eps band, rule, theta
bucket) key, parked and unparked under a cap, slot credits leased
between engines), each with checkpoints and kill-and-resume
(``resume_family``, ``resume_family_walker``, ``StreamEngine.resume``;
``runtime/checkpoint.py`` keeps the reference's containers, so either
package resumes the other's snapshot); the 2D adaptive cubature
(``integrate_2d``, a rectangle bag) and the 8D Genz suite by
shifted-lattice QMC (``integrate_qmc``); across ``n_devices`` ranks on
``torch.distributed`` (``parallel/mesh.py``): the single-integral
wavefront (``sharded_integrate``, ``resume_sharded``), the family bag
and the demand-driven walker (``integrate_family_sharded``,
``integrate_family_walker_dd``), the 2D bag (``integrate_2d_sharded``,
``resume_2d_sharded``) and the QMC lattice (``integrate_qmc(n_devices=
)``); the offline tuning search (``tune_workload``, ``measure_trial``,
``tools/tune_table.py``); the walk
segments run in hand-written CUDA kernels (``csrc/walk_rf.cu``,
``walk_ee.cu``, ``walk_seg.cu``) on the card and in plain PyTorch on
the CPU. Entry
points run on CUDA unless ``device="cpu"`` is passed; the command line
is ``python -m ppls_tpu_torch`` (``__main__.py``).

No global dtype is set: every tensor is created with an explicit dtype.
"""

from ppls_tpu_torch.config import Backend, QuadConfig, Rule
from ppls_tpu_torch.models.integrands import (
    FAMILIES, INTEGRANDS, family_exact, get_family, get_family_ds,
    get_integrand, register_integrand)
from ppls_tpu_torch.ops.rules import eval_batch, eval_interval
from ppls_tpu_torch.parallel.device_engine import device_integrate
from ppls_tpu_torch.parallel.bag_engine import (FamilyResult,
                                                integrate_family,
                                                resume_family)
from ppls_tpu_torch.parallel.cubature import (CubatureResult, integrate_2d,
                                              integrate_2d_sharded,
                                              resume_2d_sharded)
from ppls_tpu_torch.parallel.qmc import QMCResult, integrate_qmc
from ppls_tpu_torch.parallel.sharded import (ShardedResult, resume_sharded,
                                             sharded_integrate)
from ppls_tpu_torch.parallel.sharded_bag import (integrate_family_sharded,
                                                 resume_family_sharded)
from ppls_tpu_torch.parallel.sharded_walker import (
    integrate_family_walker_dd, resume_family_walker_dd)
from ppls_tpu_torch.parallel.walker import (
    WalkerResult, integrate_family_walker, resume_family_walker)
from ppls_tpu_torch.runtime.dispatch import EngineDispatcher
from ppls_tpu_torch.runtime.host_frontier import IntegrationResult, integrate
from ppls_tpu_torch.runtime.stream import StreamEngine, StreamResult
from ppls_tpu_torch.runtime.tune import measure_trial, tune_workload

__all__ = [
    "Backend", "CubatureResult", "EngineDispatcher", "FAMILIES", "FamilyResult", "INTEGRANDS",
    "IntegrationResult", "QMCResult", "QuadConfig", "Rule", "ShardedResult",
    "StreamEngine", "StreamResult", "WalkerResult", "device_integrate",
    "eval_batch", "eval_interval", "family_exact", "get_family",
    "get_family_ds", "get_integrand", "integrate", "integrate_2d",
    "integrate_2d_sharded", "integrate_family", "integrate_family_sharded",
    "integrate_family_walker", "integrate_family_walker_dd",
    "integrate_qmc", "measure_trial", "register_integrand",
    "resume_2d_sharded", "resume_family", "resume_family_sharded",
    "resume_family_walker", "resume_family_walker_dd", "resume_sharded",
    "sharded_integrate", "tune_workload",
]
