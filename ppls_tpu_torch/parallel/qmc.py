"""Quasi-Monte-Carlo integrator: a rank-1 lattice generated on the
device, one sum per random shift, one all-reduce across ranks.

* Points are a rank-1 Korobov lattice x_k = frac(k * z / N + shift),
  z = (1, a, a^2, ...) mod N, generated on the device from two
  integers. The generators were selected by the P_2 worst-case
  criterion in the Korobov space (the table below is the reference's).
* Across ``n_devices`` ranks (``mesh.py``) each rank generates and
  evaluates its own k-stripe (``start = rank * N / n``) and the ranks'
  per-shift sums meet in one all-reduce, the reference's one ``psum``
  (the ``MPI_Reduce`` of aquadPartA.c), with no other traffic.
* Error estimation: M independent random shifts (seeded, deterministic)
  give M unbiased estimates; the reported value is their mean and the
  spread their standard error, the standard shifted-lattice estimator.

A rank's unshifted stripe is generated once per run and each shift's
points are formed from it (``(frac + shift) % 1.0``, the values
:func:`lattice_block` gives), so one (N / n, d) block and one shift's
temporaries are live at a time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ppls_tpu_torch.models.genz import GENZ, get_genz
from ppls_tpu_torch.parallel.mesh import Mesh, spmd_entry
from ppls_tpu_torch.utils.device import resolve_device
from ppls_tpu_torch.utils.metrics import RunMetrics

# Korobov generators selected by the P_2 worst-case criterion, d=8,
# product weights 2^-j (the reference's table, re-derived by its
# tools/korobov_search.py --full).
KOROBOV_A = {1 << 16: 23497, 1 << 18: 94043, 1 << 20: 125599,
             1 << 22: 728761}


def _lattice_frac(n_total: int, a_gen: int, start: int, count: int, d: int,
                  device) -> torch.Tensor:
    """The unshifted lattice points k = start..start+count-1: (k * z_j
    mod N) / N in float64. Both factors of the int64 product are below
    N <= 2^22, so it is exact; the division by N (a power of two) is
    exact on every device."""
    z = np.empty(d, dtype=np.int64)
    zj = 1
    for j in range(d):
        z[j] = zj
        zj = (zj * a_gen) % n_total
    dev = torch.device(device)
    k = start + torch.arange(count, dtype=torch.int64, device=dev)
    kz = (k[:, None] % n_total) * torch.as_tensor(z, device=dev)[None, :]
    return (kz % n_total).to(torch.float64) / float(n_total)


def lattice_block(n_total: int, a_gen: int, start: int, count: int, d: int,
                  shift: torch.Tensor) -> torch.Tensor:
    """Lattice points k = start..start+count-1 on ``shift``'s device:
    x_k = frac((k * z mod N) / N + shift) with z_j = a^j mod N, so the
    coordinates are exact rationals k'/N before the shift. torch's float
    ``%`` takes the divisor's sign, as jnp's does."""
    frac = _lattice_frac(n_total, a_gen, start, count, d, shift.device)
    return (frac + shift[None, :]) % 1.0


@dataclasses.dataclass
class QMCResult:
    value: float                 # mean over shifts
    std_error: float             # std of shift estimates / sqrt(M)
    estimates: np.ndarray        # (n_shifts,)
    metrics: RunMetrics
    exact: Optional[float] = None

    @property
    def abs_error(self) -> Optional[float]:
        return None if self.exact is None else abs(self.value - self.exact)


def _stripe_sums(fn: Callable, a: np.ndarray, u: np.ndarray,
                 shifts: np.ndarray, n_points: int, start: int, count: int,
                 dev) -> torch.Tensor:
    """(n_shifts,) sums of ``fn`` over lattice points start..start+count-1
    under each shift, on ``dev``."""
    d = a.shape[0]
    a_t = torch.as_tensor(a, device=dev)
    u_t = torch.as_tensor(u, device=dev)
    shifts_t = torch.as_tensor(shifts, device=dev)
    frac = _lattice_frac(n_points, KOROBOV_A[n_points], start, count, d,
                         dev)
    return torch.stack([torch.sum(fn((frac + shifts_t[i][None, :]) % 1.0,
                                     a_t, u_t))
                        for i in range(shifts.shape[0])])


@spmd_entry
def _qmc_ranks(fn, a: np.ndarray, u: np.ndarray, n_points: int,
               shifts: np.ndarray, *, mesh) -> np.ndarray:
    """The SPMD body: this rank's stripe, then one all-reduce of the
    per-shift sums. Returns the (n_shifts,) estimates."""
    if isinstance(fn, str):
        fn = get_genz(fn).fn
    per_rank = n_points // mesh.size
    part = _stripe_sums(fn, a, u, shifts, n_points,
                        mesh.axis_index() * per_rank, per_rank, mesh.device)
    total = mesh.psum(part)                       # the one collective
    return mesh.syncs.pull_arrays(total / float(n_points))[0]


def _spawnable(fn: Callable, fn_name: Optional[str]):
    """The Genz family's registered name (``fn_name``, else the registry
    entry whose function is ``fn``), which spawned ranks look up again.
    Raises ``ValueError`` naming an unregistered ``fn``."""
    if fn_name is not None and get_genz(fn_name).fn is fn:
        return fn_name
    for name, fam in GENZ.items():
        if fam.fn is fn:
            return name
    raise ValueError(
        f"integrand {getattr(fn, '__qualname__', fn)!r} is not a "
        f"registered Genz family (models/genz.py); a world of several "
        f"ranks looks its integrand up by name")


def integrate_qmc(fn: Callable, a: np.ndarray, u: np.ndarray,
                  n_points: int = 1 << 18,
                  n_shifts: int = 8,
                  seed: int = 17,
                  mesh: Optional[Mesh] = None,
                  n_devices: Optional[int] = None,
                  fn_name: Optional[str] = None,
                  exact: Optional[float] = None,
                  device="cuda") -> QMCResult:
    """Integrate ``fn(x, a, u)`` over [0,1]^d with a shifted rank-1
    lattice on ``device`` (CUDA by default; without a card this raises
    unless ``device="cpu"``).

    ``n_points`` must be one of the precomputed ``KOROBOV_A`` sizes.
    ``mesh``, a rank's :class:`~ppls_tpu_torch.parallel.mesh.Mesh` (one
    from ``mesh.launch``, or a persistent world's), runs this rank's
    stripe on the mesh's device and spawns nothing; ``device`` and
    ``n_devices`` are then not read. Otherwise ``n_devices`` None or 1
    runs on the one device; more split the lattice's k range over that
    many ranks (``n_points`` must divide evenly), started by
    ``mesh.launch`` unless the call is made inside a process group.
    Spawned ranks look ``fn`` up by its Genz name (``fn_name``, or the
    registry entry holding ``fn``)."""
    if n_points not in KOROBOV_A:
        raise ValueError(f"n_points must be one of {sorted(KOROBOV_A)}")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1")
    if mesh is None:
        dev = resolve_device(device)
        n_dev = 1 if n_devices is None else int(n_devices)
    else:
        n_dev = mesh.size
    if n_points % n_dev:
        raise ValueError(f"n_points={n_points} not divisible by mesh "
                         f"size {n_dev}")
    a = np.asarray(a, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    rng = np.random.default_rng(seed)
    shifts = rng.random((n_shifts, a.shape[0]))

    t0 = time.perf_counter()
    if mesh is not None:
        # the rank body on the caller's mesh, whatever group it holds
        est = _qmc_ranks.__wrapped__(fn, a, u, n_points, shifts, mesh=mesh)
    elif n_dev == 1:
        sums = _stripe_sums(fn, a, u, shifts, n_points, 0, n_points, dev)
        est = (sums / float(n_points)).cpu().numpy()      # the one read
    else:
        if not dist.is_initialized():
            fn = _spawnable(fn, fn_name)
        est = _qmc_ranks(fn, a, u, n_points, shifts, n_devices=n_dev,
                         device=device)
    wall = time.perf_counter() - t0

    if not np.all(np.isfinite(est)):
        raise FloatingPointError("QMC produced non-finite estimates")
    value = float(np.mean(est))
    std_err = float(np.std(est, ddof=1) / np.sqrt(n_shifts)) \
        if n_shifts > 1 else 0.0

    evals = n_points * n_shifts
    metrics = RunMetrics(
        tasks=evals, splits=0, leaves=evals, rounds=1, max_depth=0,
        integrand_evals=evals, wall_time_s=wall, n_chips=n_dev,
        tasks_per_chip=[evals // n_dev] * n_dev)
    return QMCResult(value=value, std_error=std_err, estimates=est,
                     metrics=metrics, exact=exact)
