"""The backends of the port (``ppls_tpu_torch/backends``) against the
reference's, on the CPU: the C sequential driver and the single-process
MPI stub built from the port's own copies of the C sources, the MPI gate,
and the CPU spillover arm (``run_spillover_single``,
``SpilloverExecutor``).

Tolerances: the C programs print the reference's golden numbers exactly
(tests/test_backend.py). Spillover runs the port's float64 bag on the
CPU: its task counts equal the reference's; its areas are bit-equal on
the dyadic ``quad_scaled`` family and within 1e-14 relative otherwise
(the two libraries' transcendentals differ in the last ulp).
"""

import os

import numpy as np
import pytest

from ppls_tpu.backends import spillover as RSp
from ppls_tpu.config import QuadConfig as RQuad
from ppls_tpu_torch.backends import mpi_backend as TM
from ppls_tpu_torch.backends import spillover as TSp
from ppls_tpu_torch.config import REFERENCE_CONFIG, QuadConfig, Rule
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.runtime.host_frontier import integrate

AREA_REL = 1e-14


@pytest.fixture(scope="module")
def seq():
    if TM.build_seq() is None:
        pytest.skip("no C compiler on PATH")
    return TM.run_seq(REFERENCE_CONFIG)


def test_sources_are_the_ports_own_copies():
    csrc = os.path.join(os.path.dirname(TM.__file__), "csrc")
    assert sorted(f for f in os.listdir(csrc) if "." in f) == [
        "aquad_common.h", "aquad_mpi.c", "aquad_seq.c", "mpi_stub.h"]
    assert TM._BUILD == os.path.join(csrc, "build")


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Four threads build the sequential driver into an empty build
    directory at once: one compile, every caller gets the finished
    binary (it runs and prints the golden area), no temporary is left."""
    import threading
    if TM._cc() is None:
        pytest.skip("no C compiler on PATH")
    monkeypatch.setattr(TM, "_BUILD", str(tmp_path / "build"))
    compiles = []
    real = TM._compile

    def counted(cmd):
        compiles.append(cmd)
        real(cmd)

    monkeypatch.setattr(TM, "_compile", counted)
    out, gate = [], threading.Barrier(4)

    def build():
        gate.wait()
        out.append(TM.build_seq())

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiles) == 1
    assert out == [str(tmp_path / "build" / "aquad_seq")] * 4
    assert sorted(os.listdir(tmp_path / "build")) == ["aquad_seq",
                                                      "aquad_seq.lock"]
    res = TM.run_seq(REFERENCE_CONFIG)      # runs the binary just built
    assert f"{res.area:.6f}" == "7583461.801486" and len(compiles) == 1


def test_seq_backend_golden(seq):
    assert f"{seq.area:.6f}" == "7583461.801486"
    m = seq.metrics
    assert (m.tasks, m.splits, m.leaves, m.max_depth) == (6567, 3283, 3284,
                                                          14)
    assert m.rounds == 0 and m.n_chips == 1


def test_seq_matches_host_engine(seq):
    j = integrate(REFERENCE_CONFIG, device="cpu")
    assert seq.metrics.tasks == j.metrics.tasks
    assert seq.metrics.splits == j.metrics.splits
    assert abs(seq.area - j.area) < 1e-6
    assert seq.exact == j.exact


def test_seq_family_member(seq):
    rec = TM.run_seq_family("sin_recip_scaled", 1.5, 1e-2, 1.0, 1e-7)
    assert rec["tasks"] > 0 and np.isfinite(rec["area"])
    with pytest.raises(ValueError, match="families"):
        TM.run_seq_family("cosh4_scaled", 1.0, 0.0, 5.0, 1e-3)


def test_backend_rejects_simpson_and_unknown_integrand():
    with pytest.raises(ValueError, match="trapezoid"):
        TM.run_seq(REFERENCE_CONFIG.replace(rule=Rule.SIMPSON))
    with pytest.raises(ValueError, match="integrands"):
        TM.run_seq(REFERENCE_CONFIG.replace(integrand="runge"))


def test_mpi_gated():
    if not TM.mpi_available():
        assert TM.build_mpi() is None
        with pytest.raises(RuntimeError, match="mpicc"):
            TM.run_mpi(REFERENCE_CONFIG)
    else:
        res = TM.run_mpi(REFERENCE_CONFIG, n_workers=4)
        assert f"{res.area:.6f}" == "7583461.801486"
        assert res.metrics.tasks == 6567


def test_mpi_stub_golden_parity(seq):
    res = TM.run_mpi_stub(REFERENCE_CONFIG, n_workers=4)
    assert f"{res.area:.6f}" == "7583461.801486"
    m = res.metrics
    assert (m.tasks, m.splits, m.max_depth) == (6567, 3283, 14)
    tpr = m.tasks_per_chip
    # rank 0 is the farmer; every worker rank got work (no balance ratio:
    # the split across threads depends on the scheduler)
    assert tpr[0] == 0 and len(tpr) == 5
    assert sum(tpr[1:]) == 6567 and min(tpr[1:]) > 0


@pytest.mark.parametrize("n_workers", [1, 7])
def test_mpi_stub_worker_count_invariance(seq, n_workers):
    res = TM.run_mpi_stub(REFERENCE_CONFIG, n_workers=n_workers)
    assert res.metrics.tasks == 6567
    assert f"{res.area:.6f}" == "7583461.801486"


# ---------------------------------------------------------------------------
# CPU spillover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(),                                               # the reference
    dict(integrand="sin", a=0.0, b=1.0, eps=1e-6),        # problem; SIN
])
def test_spillover_single_matches_reference(cfg):
    ref = RSp.run_spillover_single(RQuad(**cfg))
    got = TSp.run_spillover_single(QuadConfig(**cfg))
    for k in ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals"):
        assert getattr(got.metrics, k) == getattr(ref.metrics, k), k
    assert abs(got.area - ref.area) <= AREA_REL * abs(ref.area)
    assert got.exact == ref.exact and got.global_error < 1.0
    if not cfg:
        assert f"{got.area:.6f}" == "7583461.801486"
        assert got.metrics.tasks == 6567


@pytest.mark.parametrize("family,theta,bounds,eps,exact_bits", [
    ("quad_scaled", 1.5, (0.0, 1.0), 1e-9, True),
    ("sin_recip_scaled", (1.0, 1.5), (1e-2, 1.0), 1e-7, False),
])
def test_spillover_executor_matches_reference(family, theta, bounds, eps,
                                              exact_bits):
    tel = Telemetry()
    ex = TSp.SpilloverExecutor(family, eps, chunk=1 << 10,
                               capacity=1 << 16, telemetry=tel)
    rex = RSp.SpilloverExecutor(family, eps, chunk=1 << 10,
                                capacity=1 << 16)
    areas, tasks, _ = ex.run(theta, bounds)
    ref_areas, ref_tasks, _ = rex.run(theta, bounds)
    assert tasks == ref_tasks > 0
    if exact_bits:
        assert areas == ref_areas
    else:
        np.testing.assert_allclose(areas, ref_areas, rtol=AREA_REL, atol=0)
    assert ex.device == "cpu" and TSp.spillover_available()
    assert ex.requests_total == 1 and ex.tasks_total == tasks
    assert tel.registry.value("ppls_spillover_requests_total") == 1
    assert tel.registry.value("ppls_spillover_tasks_total") == tasks


def test_spillover_executor_caps_chunk_and_refuses_nan():
    ex = TSp.SpilloverExecutor("quad_scaled", 1e-9, chunk=1 << 15,
                               capacity=1 << 16)
    assert ex.chunk == 1 << 12
    with pytest.raises(FloatingPointError):
        ex.run(float("nan"), (0.0, 1.0))
