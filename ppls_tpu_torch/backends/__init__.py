"""Backend dispatch: ``backend={jax, mpi, spillover}``.

``jax`` (the reference's name, kept for the same argv) is this package's
engines on the card. ``mpi`` runs the C farmer/worker program
(``mpi_backend``; the real MPI binary only with an MPI toolchain, the
sequential driver and the single-process stub with any C compiler).
``spillover`` runs float64 bag rounds on the host CPU, by design
(``spillover``).
"""

from ppls_tpu_torch.backends.mpi_backend import (
    build_mpi,
    build_seq,
    mpi_available,
    run_mpi,
    run_seq,
)
from ppls_tpu_torch.backends.spillover import (
    SpilloverExecutor,
    run_spillover_single,
    spillover_available,
)

__all__ = ["build_mpi", "build_seq", "mpi_available", "run_mpi",
           "run_seq", "SpilloverExecutor", "run_spillover_single",
           "spillover_available"]
