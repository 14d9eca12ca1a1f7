"""Run metrics shared by the engines."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass
class RoundStats:
    """One engine round (one bag round, or one walker cycle)."""

    round_index: int
    frontier_width: int      # active intervals evaluated this round
    splits: int              # intervals that refined
    leaves: int              # intervals accepted into the area
    padded_width: int = 0    # padded batch width actually launched

    @property
    def accept_rate(self) -> float:
        return self.leaves / self.frontier_width if self.frontier_width else 0.0


@dataclasses.dataclass
class RunMetrics:
    """Aggregate metrics for one integration run."""

    tasks: int = 0           # total intervals evaluated
    splits: int = 0
    leaves: int = 0
    rounds: int = 0
    max_depth: int = 0
    integrand_evals: int = 0  # distinct f(x) evaluations
    wall_time_s: float = 0.0
    n_chips: int = 1
    tasks_per_chip: Optional[List[int]] = None
    per_round: List[RoundStats] = dataclasses.field(default_factory=list)

    @property
    def evals_per_sec_per_chip(self) -> float:
        if self.wall_time_s <= 0:
            return 0.0
        return self.integrand_evals / self.wall_time_s / max(self.n_chips, 1)

    @property
    def tasks_per_sec_per_chip(self) -> float:
        if self.wall_time_s <= 0:
            return 0.0
        return self.tasks / self.wall_time_s / max(self.n_chips, 1)


def round_stats_from_rows(rows, fields: Sequence[str],
                          padded_width: int = 0) -> List[RoundStats]:
    """One :class:`RoundStats` per row of a per-cycle stats array whose
    columns ``fields`` include ``tasks`` and ``splits``."""
    if rows is None or len(rows) == 0:
        return []
    i_t = list(fields).index("tasks")
    i_s = list(fields).index("splits")
    out: List[RoundStats] = []
    for i, row in enumerate(rows):
        t, s = int(row[i_t]), int(row[i_s])
        out.append(RoundStats(round_index=i, frontier_width=t,
                              splits=s, leaves=t - s,
                              padded_width=padded_width))
    return out
