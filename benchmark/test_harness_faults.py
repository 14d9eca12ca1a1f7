"""The check against planted faults: each cell's run, driven through the
harness on the CPU at a small size (the look for a card skipped), comes
out correct when sound and not correct with each fault the cell can
have under its timed path. About a minute on one process."""

import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.append(os.path.dirname(HERE))

import faults  # noqa: E402
import harness  # noqa: E402

SMALL = {"bounds": [1e-2, 1.0], "eps": 1e-6,
         "batch": {"lanes": 256, "roots_per_lane": 2, "refill_slots": 2,
                   "chunk": 1024, "capacity": 65536, "max_segments": 24,
                   "max_cycles": 8},
         "stream": {"slots": 16, "chunk": 1024, "capacity": 65536,
                    "lanes": 256, "roots_per_lane": 2, "refill_slots": 2,
                    "max_segments": 24}}
TRAFFIC = {"members_per_chip": 8, "thetas_per_request": 4,
           "check_answers": 16, "clients": 16, "block": 16,
           "warm_phases": 1}
CELLS = {"flagship.family": ("stalled_step", "half_batch",
                             "altered_answer"),
         "flagship.serve": ("stalled_step", "half_batch", "altered_answer")}


def _run(cell, fault=None, monkeypatch=None):
    import drivers.stream
    if monkeypatch is not None:
        # a request that never retires is waited for this long
        monkeypatch.setattr(drivers.stream, "LATE_S", 5.0)
    if fault:
        faults.plant(fault, monkeypatch.setattr)
    os.environ.setdefault("PPLS_TUNING_TABLE", "off")
    return harness.run_cell(harness.load_manifest(), cell, 2 ** 31 + 99,
                            0.6, False, device="cpu",
                            t_start=time.perf_counter(),
                            overrides={"config": SMALL, "traffic": TRAFFIC},
                            log=lambda msg: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, monkeypatch):
    out = _run(cell, monkeypatch=monkeypatch)
    assert out["correct"], out["check"]
    assert out["check"]["area_gap"]["value"] < 1e-12


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in CELLS[c]])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    out = _run(cell, fault, monkeypatch)
    assert not out["correct"], (cell, fault, out["check"])

