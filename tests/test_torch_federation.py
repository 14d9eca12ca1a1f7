"""The port's federated metrics (``ppls_tpu_torch.obs.federation``) and
the stream's phase-row accessors the cluster worker reads, against the
reference's, on the CPU. No process is spawned here.

* ``FederatedMetrics`` fed the same cumulative dumps as the reference's
  (the inputs of tests/test_request_trace.py::test_federation_merge_unit,
  a counter that restarts from zero, a gauge overwritten, histograms on
  both shared bucket tables merged across re-shipments and a restart):
  equal federated children, equal ``reconcile()`` output, equal
  ``sum_over_workers`` and equal ``exposition()`` text; an unknown
  bucket table refused in the reference's words.
* ``StreamEngine.last_phase_row`` / ``phase_rows_len`` after each phase
  of the same stream (tests/test_cluster.py's dyadic workload, the
  float64 mode and the walk), equal to the reference engine's.
"""

import numpy as np
import pytest

from ppls_tpu.obs.federation import FederatedMetrics as RefFederated
from ppls_tpu.obs.registry import MetricsRegistry as RefRegistry
from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu_torch.obs.federation import (COORDINATOR, PROCESS_LABEL,
                                           FederatedMetrics)
from ppls_tpu_torch.obs.registry import SECONDS_BUCKETS, MetricsRegistry
from ppls_tpu_torch.runtime.stream import StreamEngine

# tests/test_cluster.py:46-59
WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=32,
           min_active_frac=0.05, f64_rounds=2)
THETA6 = [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]
REQS6 = [(t, (0.0, 1.0)) for t in THETA6]
ARR6 = [0, 0, 1, 2, 3, 4]


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _worker_dumps(reg_cls):
    """The cumulative dumps one process ships, in order: the
    test_federation_merge_unit sequence (two shipments, a retransmit),
    then a fresh restart that re-reports from a lower count, plus a
    gauge, a seconds histogram and a labelled histogram."""
    w = reg_cls()
    x = w.counter("ppls_x_total", "x", ("tenant",))
    lat = w.histogram("ppls_stream_retire_latency_phases", "lat")
    x.labels(tenant="a").inc(3)
    lat.observe(5)
    out = [w.dump()]
    x.labels(tenant="a").inc(2)
    lat.observe(9)
    g = w.gauge("ppls_live_rows", "rows", ("slot",))
    g.labels(slot="0").set(7)
    w.histogram("ppls_stream_retire_latency_seconds", "s",
                buckets=SECONDS_BUCKETS).observe(0.03)
    out += [w.dump(), w.dump()]
    g.labels(slot="0").set(2)
    w.histogram("ppls_stream_class_latency_phases", "c",
                labelnames=("priority",)).labels(priority="1").observe(3)
    out.append(w.dump())
    # a fresh restart: every value re-reported from zero, lower than the
    # last shipment
    w2 = reg_cls()
    w2.counter("ppls_x_total", "x", ("tenant",)).labels(tenant="a").inc(1)
    w2.histogram("ppls_stream_retire_latency_phases", "lat").observe(2)
    w2.gauge("ppls_live_rows", "rows", ("slot",)).labels(slot="0").set(1)
    out.append(w2.dump())
    return out


def _federate(fed_cls, reg_cls):
    fed = fed_cls()
    trail = []
    for i, d in enumerate(_worker_dumps(reg_cls)):
        fed.ingest_dump("0", d)
        fed.ingest_dump("1", d if i < 2 else _worker_dumps(reg_cls)[1])
        coord = reg_cls()
        coord.counter("ppls_stream_retired_total", "r").inc(i + 1)
        fed.ingest_dump("coordinator", coord.dump())
        trail.append((fed.reconcile(),
                      fed.sum_over_workers("ppls_x_total", tenant="a"),
                      fed.sum_over_workers("ppls_stream_retired_total"),
                      fed.registry.dump(), fed.registry.exposition()))
    return fed, trail


def test_federation_matches_reference_on_identical_dumps():
    fed, got = _federate(FederatedMetrics, MetricsRegistry)
    _ref, want = _federate(RefFederated, RefRegistry)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g == w
    # reconciled up to the restart; after it the clamped counter and the
    # restarted histogram sit above the re-reported values, in both
    assert all(t[0] == [] for t in got[:4])
    assert len(got[-1][0]) == 2
    assert fed.processes() == ["0", "1", COORDINATOR]
    # the unit test's numbers: 3 + 2 = 5, then the restart's clamp adds
    # the restarted process's whole re-reported value
    assert got[2][1] == 10.0 and got[-1][1] == 6.0 + 5.0
    hist = fed.registry.get("ppls_stream_retire_latency_phases")
    assert hist.labelnames == (PROCESS_LABEL,)
    # 9 lands in the (8, 12] bucket; the restart's 2 joins process 0
    child = hist.labels(process="1")
    assert child.count == 2 and child.quantile(0.99) == 12.0
    assert hist.labels(process="0").count == 3
    assert fed.registry.value("ppls_live_rows", slot="0",
                              process="0") == 1.0


def test_federation_refuses_an_unknown_bucket_table():
    def bad(reg_cls):
        w = reg_cls()
        w.histogram("ppls_odd", "o", buckets=(1.0, 2.0)).observe(1.5)
        return w.dump()

    with pytest.raises(ValueError) as ep:
        FederatedMetrics().ingest_dump("0", bad(MetricsRegistry))
    with pytest.raises(ValueError) as er:
        RefFederated().ingest_dump("0", bad(RefRegistry))
    assert str(ep.value) == str(er.value)
    assert "unknown bucket table" in str(ep.value)


@pytest.mark.parametrize("f64_rounds", [2, 0], ids=["f64", "walker"])
def test_last_phase_row_matches_reference(f64_rounds):
    kw = dict(WKW, f64_rounds=f64_rounds)
    port = StreamEngine("quad_scaled", 1e-9, device="cpu", **kw)
    ref = RefStream("quad_scaled", 1e-9, **kw)
    assert port.last_phase_row() is None and ref.last_phase_row() is None
    assert port.phase_rows_len() == ref.phase_rows_len() == 0
    k, rows = 0, 0
    while k < len(REQS6) or not ref.idle:
        while k < len(REQS6) and ARR6[k] <= ref.phase:
            port.submit(*REQS6[k])
            ref.submit(*REQS6[k])
            k += 1
        port.step()
        ref.step()
        assert port.phase == ref.phase
        assert port.phase_rows_len() == ref.phase_rows_len()
        assert port.last_phase_row() == ref.last_phase_row()
        rows = port.phase_rows_len()
    assert port.idle and rows > 0
    row = port.last_phase_row()
    assert all(isinstance(v, int) for v in row.values())
    # an idle phase appends no row: the count stays, as the worker
    # protocol relies on
    port.step()
    assert port.phase_rows_len() == rows
    assert np.array_equal(port.result().areas, ref.result().areas)
