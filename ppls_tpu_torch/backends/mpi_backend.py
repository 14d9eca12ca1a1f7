"""MPI backend: the C farmer/worker program, for parity with the design
of the reference C program (a farmer with a LIFO bag and demand-driven
dispatch, workers running the trapezoid evaluate-or-split step).

The sources are the port's own copies under ``csrc/``. The MPI binary
builds only where an MPI toolchain (``mpicc``, ``mpirun``) exists; the
sequential driver (``csrc/aquad_seq.c``) and the single-process MPI stub
build with a plain C compiler into ``csrc/build/``. ``run_seq`` is the
CPU golden baseline.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import subprocess
from typing import Optional

from ppls_tpu_torch.config import QuadConfig, Rule
from ppls_tpu_torch.runtime.host_frontier import IntegrationResult
from ppls_tpu_torch.utils.metrics import RunMetrics

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD = os.path.join(_CSRC, "build")

# integrand ids of the f_eval switch in csrc/aquad_common.h; families
# take a scale argument (aq_scale)
_C_INTEGRANDS = {"cosh4": 0, "sin": 1, "sin_recip": 2}
_C_FAMILIES = {"sin_recip_scaled": 3}


def mpi_available() -> bool:
    return shutil.which("mpicc") is not None \
        and shutil.which("mpirun") is not None


def _src_mtime(src: str) -> float:
    """mtime of a C source and of the header it includes (the header
    carries the integrands and the accumulation)."""
    header = os.path.join(_CSRC, "aquad_common.h")
    return max(os.path.getmtime(src), os.path.getmtime(header))


def _cc() -> Optional[str]:
    for cc in ("cc", "gcc", "clang"):
        if shutil.which(cc):
            return cc
    return None


def _compile(cmd: list) -> None:
    """Run a compiler, with its stderr in the error on failure."""
    try:
        subprocess.run(cmd, check=True, cwd=_CSRC, capture_output=True,
                       text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"compile failed: {' '.join(cmd)}\n{e.stderr}") from e


def _build(name: str, src: str, cmd_head: list, newest: float,
           force: bool, libs: list) -> str:
    """Compile ``src`` into ``build/<name>`` unless a binary newer than
    the sources is there. The build holds an exclusive ``flock`` of
    ``<name>.lock`` and compiles to a temporary name that is renamed
    into place, so processes that race build once and none of them
    runs a half-written binary."""
    out = os.path.join(_BUILD, name)

    def fresh() -> bool:
        return os.path.exists(out) and os.path.getmtime(out) >= newest

    if fresh() and not force:
        return out
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh() and not force:
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            _compile(cmd_head + ["-o", tmp, src] + libs)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def build_seq(force: bool = False) -> Optional[str]:
    """Build the sequential C driver; its path, or None without a C
    compiler."""
    cc = _cc()
    if cc is None:
        return None
    src = os.path.join(_CSRC, "aquad_seq.c")
    return _build("aquad_seq", src, [cc, "-O2"], _src_mtime(src), force,
                  ["-lm"])


def build_mpi(force: bool = False) -> Optional[str]:
    """Build the MPI farmer/worker binary; None without an MPI
    toolchain."""
    if not mpi_available():
        return None
    src = os.path.join(_CSRC, "aquad_mpi.c")
    return _build("aquad_mpi", src, ["mpicc", "-O2"], _src_mtime(src),
                  force, ["-lm"])


def build_mpi_stub(force: bool = False) -> Optional[str]:
    """Build the farmer/worker binary against the single-process MPI
    stub (``csrc/mpi_stub.h``: ranks as threads, in-process mailboxes)
    with a plain C compiler; None without one."""
    cc = _cc()
    if cc is None:
        return None
    src = os.path.join(_CSRC, "aquad_mpi.c")
    newest = max(_src_mtime(src),
                 os.path.getmtime(os.path.join(_CSRC, "mpi_stub.h")))
    return _build("aquad_mpi_stub", src, [cc, "-O2", "-DAQ_MPI_STUB"],
                  newest, force, ["-lm", "-lpthread"])


def _check_config(config: QuadConfig) -> int:
    if Rule(config.rule) != Rule.TRAPEZOID:
        raise ValueError("the C backends implement the reference's "
                         "trapezoid rule only")
    if config.integrand not in _C_INTEGRANDS:
        raise ValueError(
            f"C backends support integrands {sorted(_C_INTEGRANDS)}; "
            f"got {config.integrand!r}")
    return _C_INTEGRANDS[config.integrand]


def _parse_result(stdout: str, config: QuadConfig,
                  n_chips: int) -> IntegrationResult:
    from ppls_tpu_torch.models.integrands import get_integrand

    d = json.loads(stdout.strip().splitlines()[-1])
    metrics = RunMetrics(
        tasks=d["tasks"], splits=d["splits"],
        leaves=d["tasks"] - d["splits"],
        rounds=0,  # bag order, not wavefront rounds
        max_depth=d.get("max_depth", 0), integrand_evals=d["evals"],
        wall_time_s=d["wall_time_s"], n_chips=n_chips,
        tasks_per_chip=d.get("tasks_per_rank"))
    return IntegrationResult(
        area=d["area"], config=config, metrics=metrics,
        exact=get_integrand(config.integrand).exact(config.a, config.b))


def _argv(fid: int, config: QuadConfig) -> list:
    return [str(fid), repr(config.a), repr(config.b), repr(config.eps)]


def run_seq(config: QuadConfig) -> IntegrationResult:
    """Run the sequential C driver (the CPU baseline)."""
    fid = _check_config(config)
    binary = build_seq()
    if binary is None:
        raise RuntimeError("no C compiler available for the seq backend")
    proc = subprocess.run([binary] + _argv(fid, config),
                          capture_output=True, text=True, check=True)
    return _parse_result(proc.stdout, config, n_chips=1)


def run_seq_family(family: str, scale: float, a: float, b: float,
                   eps: float) -> dict:
    """Run the sequential C driver on one member of a parameterised
    family; returns its JSON record (area, tasks, evals, wall_time_s)."""
    if family not in _C_FAMILIES:
        raise ValueError(
            f"C backends support families {sorted(_C_FAMILIES)}; "
            f"got {family!r}")
    binary = build_seq()
    if binary is None:
        raise RuntimeError("no C compiler available for the seq backend")
    proc = subprocess.run(
        [binary, str(_C_FAMILIES[family]), repr(a), repr(b), repr(eps),
         repr(float(scale))],
        capture_output=True, text=True, check=True)
    return json.loads(proc.stdout)


# 2D integrands the C backend implements (ids must match f2/g2_fid in
# aquad_seq.c); values are (fid2, default_param). The param is the
# Gaussian width sigma for both.
_C_INTEGRANDS_2D = {"gauss2d_peak": (0, 0.05), "gauss2d_ring": (1, 0.05)}


def run_seq_2d(integrand: str, ax: float, bx: float, ay: float,
               by: float, eps: float) -> dict:
    """Run the sequential C rectangle-bag driver (the 2D CPU baseline) on
    one registered 2D integrand; returns the raw JSON record (area,
    tasks=cells, splits, evals, max_depth, wall_time_s). Cells and split
    decisions match ``parallel/cubature.integrate_2d`` with the
    trapezoid rule exactly (the same float64 9-point test)."""
    if integrand not in _C_INTEGRANDS_2D:
        raise ValueError(
            f"C 2D backend supports {sorted(_C_INTEGRANDS_2D)}; "
            f"got {integrand!r}")
    fid2, param = _C_INTEGRANDS_2D[integrand]
    binary = build_seq()
    if binary is None:
        raise RuntimeError("no C compiler available for the seq backend")
    proc = subprocess.run(
        [binary, "2d", str(fid2), repr(ax), repr(bx), repr(ay),
         repr(by), repr(eps), repr(param)],
        capture_output=True, text=True, check=True)
    return json.loads(proc.stdout)


def run_mpi_stub(config: QuadConfig, n_workers: int = 4
                 ) -> IntegrationResult:
    """The farmer/worker protocol in one process over the MPI stub (one
    farmer and ``n_workers`` worker threads): the source, protocol and
    golden numbers of :func:`run_mpi`, without an MPI toolchain."""
    fid = _check_config(config)
    binary = build_mpi_stub()
    if binary is None:
        raise RuntimeError("no C compiler available for the MPI stub")
    env = dict(os.environ, AQ_STUB_NP=str(n_workers + 1))
    proc = subprocess.run([binary] + _argv(fid, config),
                          capture_output=True, text=True, check=True,
                          env=env)
    return _parse_result(proc.stdout, config, n_chips=n_workers)


def run_mpi(config: QuadConfig, n_workers: int = 4) -> IntegrationResult:
    """Run the MPI farmer/worker binary with ``n_workers`` workers."""
    fid = _check_config(config)
    binary = build_mpi()
    if binary is None:
        raise RuntimeError(
            "MPI backend requested but no mpicc/mpirun on PATH; install an "
            "MPI toolchain or use backend='jax'")
    proc = subprocess.run(
        ["mpirun", "--oversubscribe", "-n", str(n_workers + 1), binary]
        + _argv(fid, config),
        capture_output=True, text=True, check=True)
    return _parse_result(proc.stdout, config, n_chips=n_workers)
