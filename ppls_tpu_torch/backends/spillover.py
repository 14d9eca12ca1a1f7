"""CPU spillover backend: slower-but-correct capacity beside the card.

A request that overflows the streaming engine's queue, or a
single-integral run with ``--backend spillover``, runs as float64 bag
rounds (``parallel/bag_engine.integrate_family``) on the host CPU. That
is the design, not a fallback: the reference pins this arm to the host
CPU too (its ``jax.default_device`` of the ``cpu`` backend), so that
drained tails and overload bursts run beside the card while the card
stays busy with the engine's own work. Nothing here ever runs on CUDA.

Correctness: the spillover path is the float64 bag engine, so its areas
are bit-identical to the stream's float64 mode on dyadic workloads and
within the ds walk's ~1e-9 of the walker otherwise. Engagement is
counted from the bag engine's own task counters
(``ppls_spillover_requests_total``, ``ppls_spillover_tasks_total``),
and every completed record it produces carries ``spillover=True``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from ppls_tpu_torch.config import QuadConfig, Rule

# the spillover arm's device, fixed by design
SPILLOVER_DEVICE = "cpu"


def spillover_available() -> bool:
    """PyTorch always has its CPU device, so spillover is always
    available (the reference's depends on its JAX build)."""
    return True


class SpilloverExecutor:
    """Runs one request at a time through the float64 bag engine on the
    host CPU. The engines call :meth:`run` only at phase boundaries;
    every run's task count accumulates into the registry."""

    def __init__(self, family: str, eps: float,
                 rule: Rule = Rule.TRAPEZOID,
                 chunk: int = 1 << 10, capacity: int = 1 << 16,
                 telemetry=None):
        from ppls_tpu_torch.models.integrands import get_family
        self.family = family
        self.f_theta = get_family(family)
        self.eps = float(eps)
        self.rule = Rule(rule)
        # one chunk cap for every caller: spillover runs beside the
        # engine, never with its device-sized chunks
        self.chunk = min(int(chunk), 1 << 12)
        self.capacity = int(capacity)
        self.device = SPILLOVER_DEVICE
        self.requests_total = 0
        self.tasks_total = 0
        self.wall_total = 0.0
        self._c_req = self._c_tasks = None
        if telemetry is not None:
            self._c_req = telemetry.registry.counter(
                "ppls_spillover_requests_total",
                "requests completed on the CPU spillover backend")
            self._c_tasks = telemetry.registry.counter(
                "ppls_spillover_tasks_total",
                "device-counted bag tasks executed by the CPU "
                "spillover backend")

    def run(self, theta, bounds: Tuple[float, float]
            ) -> Tuple[list, int, float]:
        """Integrate one request (a scalar theta or a theta batch) to
        completion on the CPU. Returns (per-theta areas, tasks, wall
        seconds); a non-finite area raises ``FloatingPointError``."""
        from ppls_tpu_torch.parallel.bag_engine import integrate_family
        thetas = (np.asarray(theta, dtype=np.float64).reshape(-1)
                  if isinstance(theta, (tuple, list, np.ndarray))
                  else np.array([float(theta)]))
        t0 = time.perf_counter()
        res = integrate_family(self.f_theta, thetas, bounds, self.eps,
                               rule=self.rule, chunk=self.chunk,
                               capacity=self.capacity, device=self.device)
        wall = time.perf_counter() - t0
        tasks = int(res.metrics.tasks)
        self.requests_total += 1
        self.tasks_total += tasks
        self.wall_total += wall
        if self._c_req is not None:
            self._c_req.inc()
            self._c_tasks.inc(tasks)
        return [float(v) for v in np.asarray(res.areas)], tasks, wall


@dataclasses.dataclass
class SpilloverRunResult:
    """The single-integral CLI's result shape for the spillover arm."""

    area: float
    exact: Optional[float]
    metrics: object

    @property
    def global_error(self) -> Optional[float]:
        if self.exact is None:
            return None
        return abs(self.area - self.exact)


def run_spillover_single(config: QuadConfig) -> SpilloverRunResult:
    """``--backend spillover``: one ``QuadConfig`` problem as float64 bag
    rounds on the host CPU."""
    from ppls_tpu_torch.models.integrands import get_integrand
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    entry = get_integrand(config.integrand)
    res = integrate_family(
        lambda x, th: entry.fn(x), np.array([0.0]), (config.a, config.b),
        config.eps, rule=Rule(config.rule),
        chunk=min(config.capacity, 1 << 12), capacity=config.capacity,
        device=SPILLOVER_DEVICE)
    return SpilloverRunResult(
        area=float(np.asarray(res.areas)[0]),
        exact=entry.exact(config.a, config.b), metrics=res.metrics)
