"""Host-driven wavefront engine (the reference's
``runtime/host_frontier.py``).

The host owns the frontier, every pending interval, as a numpy array;
each round evaluates the whole frontier as one padded batch on the
device (widths bucketed to powers of two), reads back the round's leaf
sum and split mask in one device read, and compacts the split halves
into the next frontier on the host, left children first. The frontier
grows without bound, and any round boundary is a resume point
(``frontier``/``area_acc``/``metrics``; ``runtime/checkpoint.py``).

Areas agree with the reference's to the last bits, not bit for bit: a
round's leaf sum is a ``torch.sum`` whose order differs from XLA's.
Tasks, splits, rounds and depth are the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ppls_tpu_torch.config import QuadConfig, Rule
from ppls_tpu_torch.models.integrands import get_integrand
from ppls_tpu_torch.ops.reduction import masked_sum, neumaier_add_host
from ppls_tpu_torch.ops.rules import EVALS_PER_TASK, eval_batch
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device
from ppls_tpu_torch.utils.metrics import RoundStats, RunMetrics


@dataclasses.dataclass
class IntegrationResult:
    area: float
    config: QuadConfig
    metrics: RunMetrics
    exact: Optional[float] = None
    host_syncs: int = 0          # device reads by the host loop

    @property
    def global_error(self) -> Optional[float]:
        """Achieved |area - exact| (``eps`` is a per-interval split
        tolerance, not a global bound)."""
        if self.exact is None:
            return None
        return abs(self.area - self.exact)


def _bucket_width(n: int, min_batch: int) -> int:
    """Next power of two >= max(n, min_batch)."""
    w = max(int(min_batch), 1)
    while w < n:
        w <<= 1
    return w


def _round_step(l: torch.Tensor, r: torch.Tensor, active: torch.Tensor,
                f: Callable, eps: float, rule: Rule, syncs: HostSyncs
                ) -> Tuple[float, np.ndarray]:
    """Evaluate every active interval, sum the accepted values and read
    back ``(leaf_sum, split)`` in one device read."""
    value, _err, split = eval_batch(l, r, f, eps, rule)
    split = split & active
    accept = active & ~split
    leaf_sum = masked_sum(value, accept)
    (packed,) = syncs.pull_arrays(
        torch.cat((leaf_sum.reshape(1).to(torch.float64),
                   split.to(torch.float64))))
    return float(packed[0]), packed[1:] != 0.0


def integrate(config: QuadConfig = QuadConfig(),
              frontier: Optional[np.ndarray] = None,
              area_acc: Tuple[float, float] = (0.0, 0.0),
              metrics: Optional[RunMetrics] = None,
              on_round: Optional[Callable] = None,
              device="cuda") -> IntegrationResult:
    """Adaptively integrate per ``config`` with the host-driven wavefront
    loop, the rounds evaluated on ``device`` (CUDA by default; raises
    without a card unless ``device="cpu"``).

    ``frontier``/``area_acc``/``metrics`` resume a checkpointed run.
    ``on_round(round_index, frontier, area_acc, metrics)`` runs after
    each round (the checkpoint hook)."""
    dev = resolve_device(device)
    entry = get_integrand(config.integrand)
    rule = Rule(config.rule)
    eps = float(config.eps)
    dtype = np.dtype(config.dtype)
    syncs = HostSyncs()

    if frontier is None:
        frontier = np.array([[config.a, config.b]], dtype=dtype)
    else:
        frontier = np.asarray(frontier, dtype=dtype).reshape(-1, 2)
    s, c = area_acc
    metrics = metrics or RunMetrics()
    start_rounds = metrics.rounds

    t0 = time.perf_counter()
    while frontier.shape[0] > 0:
        if metrics.rounds - start_rounds >= config.max_rounds:
            raise RuntimeError(
                f"max_rounds={config.max_rounds} exceeded with "
                f"{frontier.shape[0]} intervals pending; raise max_rounds "
                f"or loosen eps")
        n = frontier.shape[0]
        width = _bucket_width(n, config.min_batch)
        # padding lanes hold an in-domain point (the first pending
        # midpoint): masked lanes still evaluate the integrand
        fill = 0.5 * (frontier[0, 0] + frontier[0, 1])
        l = np.full(width, fill, dtype=dtype)
        r = np.full(width, fill, dtype=dtype)
        l[:n] = frontier[:, 0]
        r[:n] = frontier[:, 1]
        active = torch.arange(width, device=dev) < n
        leaf_sum, split = _round_step(
            torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev),
            active, entry.fn, eps, rule, syncs)
        split_np = split[:n]
        n_split = int(split_np.sum())

        s, c = neumaier_add_host(s, c, leaf_sum)

        # both halves of each split interval, left child first: a
        # deterministic breadth-first order
        if n_split:
            ls = frontier[split_np, 0]
            rs = frontier[split_np, 1]
            mid = (ls + rs) * 0.5
            nxt = np.empty((2 * n_split, 2), dtype=dtype)
            nxt[0::2, 0] = ls
            nxt[0::2, 1] = mid
            nxt[1::2, 0] = mid
            nxt[1::2, 1] = rs
            frontier = nxt
        else:
            frontier = np.empty((0, 2), dtype=dtype)

        metrics.record_round(RoundStats(
            round_index=metrics.rounds, frontier_width=n, splits=n_split,
            leaves=n - n_split, padded_width=width))
        if on_round is not None:
            on_round(metrics.rounds, frontier, (s, c), metrics)

    metrics.wall_time_s += time.perf_counter() - t0
    metrics.max_depth = max(metrics.rounds - 1, 0)
    metrics.integrand_evals = metrics.tasks * EVALS_PER_TASK[rule]
    metrics.tasks_per_chip = [metrics.tasks]
    return IntegrationResult(area=s + c, config=config, metrics=metrics,
                             exact=entry.exact(config.a, config.b),
                             host_syncs=syncs.n)
