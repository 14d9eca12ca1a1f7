"""The tuning-table cadence tier: the port's ``runtime/tune.py`` against
the reference's, on the same signatures and tables.

* ``workload_signature``, ``signature_key``, ``nearest_entry`` and
  ``resolve_cadence_tuned`` equal the reference's (values, tier and
  entry key): on the committed ``tools/tuning_table.json`` (the
  flagship resolves to (0.98, 0.65, nearest) in both), on tables written
  to ``tmp_path`` (exact, nearest and out-of-band rows, tests/
  test_tune.py's cases), with ``PPLS_TUNING_TABLE=off``, and with a
  missing or malformed table, both of which degrade to the hand tier.
* With the committed table on, the walker and the stream at the
  reference tests' shapes on a signature the table resolves to
  ``nearest`` walk the reference's schedule: equal tasks, cycles,
  kernel steps and stats rows, areas within the 3e-9 of
  tests/test_torch_walker.py.
* On a CUDA device the rows keyed ``cpu`` do not match, so the card
  resolves through the hand tier.
"""

import json

import numpy as np
import pytest
import torch

from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
from ppls_tpu.parallel.walker import integrate_family_walker as ref_walker
from ppls_tpu.runtime import tune as rt
from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu_torch.models.integrands import (family_name_of, get_family,
                                              get_family_ds)
from ppls_tpu_torch.parallel.walker import integrate_family_walker
from ppls_tpu_torch.runtime import tune as pt
from ppls_tpu_torch.runtime.stream import StreamEngine

# (family, eps, rule, theta_block, mesh_shape, scout, refill_slots)
MOTIVATION = {
    "flagship": ("sin_recip_scaled", 1e-10, "trapezoid", 1, 1, True, 8),
    "sin_recip_1e-7": ("sin_recip_scaled", 1e-7, "trapezoid", 1, 1, True,
                       4),
    "cosh4_1e-9": ("cosh4_scaled", 1e-9, "trapezoid", 1, 1, True, 8),
    "f64_boundary": ("sin_recip_scaled", 1e-10, "trapezoid", 1, 1, False,
                     0),
}
EXPECTED = {"flagship": (0.98, 0.65, "nearest"),
            "sin_recip_1e-7": (0.98, 0.65, "exact"),
            "cosh4_1e-9": (0.80, 0.65, "nearest"),
            "f64_boundary": (0.80, 0.50, "default")}
# tests/test_tune.py's signatures (_sig and its variants)
VARIANTS = {
    "base": ("sin_recip_scaled", 1e-7, "trapezoid", 1, 1, True, 4),
    "f64-ikr": ("sin_recip_scaled", 1e-7, "trapezoid", 1, 1, False, 4),
    "scout-xla": ("sin_recip_scaled", 1e-7, "trapezoid", 1, 1, True, 0),
    "mesh8": ("sin_recip_scaled", 1e-7, "trapezoid", 1, 8, True, 4),
    "theta64": ("sin_recip_scaled", 1e-7, "trapezoid", 64, 1, True, 4),
    "simpson": ("sin_recip_scaled", 1e-7, "simpson", 1, 1, True, 4),
    "eps-9": ("sin_recip_scaled", 1e-9, "trapezoid", 1, 1, True, 4),
    "eps-8": ("sin_recip_scaled", 1e-8, "trapezoid", 1, 1, True, 4),
    "eps-12": ("sin_recip_scaled", 1e-12, "trapezoid", 1, 1, True, 4),
    "sin_scaled": ("sin_scaled", 1e-7, "trapezoid", 1, 1, True, 4),
    "sin_scaled_eps-12": ("sin_scaled", 1e-12, "trapezoid", 1, 1, True, 4),
    "cosh4": ("cosh4_scaled", 1e-7, "trapezoid", 1, 1, True, 4),
    "quad": ("quad_scaled", 1e-7, "trapezoid", 1, 1, True, 4),
    "theta2048": ("sin_scaled", 1e-5, "trapezoid", 2048, 1, True, 8),
}
SIGNATURES = dict(MOTIVATION, **VARIANTS)


def _sigs(args):
    fam, eps, rule, tb, mesh, scout, r = args
    kw = dict(scout=scout, refill_slots=r)
    return (pt.workload_signature(fam, eps, rule, tb, mesh, **kw),
            rt.workload_signature(fam, eps, rule, tb, mesh, **kw))


@pytest.fixture
def table_env(tmp_path, monkeypatch):
    """PPLS_TUNING_TABLE at a temporary table, both caches cleared."""
    path = str(tmp_path / "table.json")
    monkeypatch.setenv("PPLS_TUNING_TABLE", path)
    pt.clear_table_cache()
    rt.clear_table_cache()
    yield path
    pt.clear_table_cache()
    rt.clear_table_cache()


@pytest.fixture
def committed_table(monkeypatch):
    monkeypatch.delenv("PPLS_TUNING_TABLE", raising=False)
    pt.clear_table_cache()
    rt.clear_table_cache()
    yield
    pt.clear_table_cache()
    rt.clear_table_cache()


def _both(exit_frac, suspend_frac, args):
    """(port, reference): (exit, suspend, tier, entry key) each."""
    p_sig, r_sig = _sigs(args)
    scout, r = args[5], args[6]
    p = pt.resolve_cadence_tuned(exit_frac, suspend_frac, scout, r,
                                 signature=p_sig, device="cpu")
    p_key = pt.last_resolution()["key"]
    q = rt.resolve_cadence_tuned(exit_frac, suspend_frac, scout, r,
                                 signature=r_sig)
    q_key = rt.last_resolution()["key"]
    return p + (p_key,), q + (q_key,)


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_and_key_equal_reference(name):
    p_sig, r_sig = _sigs(SIGNATURES[name])
    assert p_sig == r_sig
    assert pt.signature_key(p_sig, "cpu") == rt.signature_key(r_sig, "cpu")


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_committed_table_resolution_equals_reference(committed_table, name):
    got, ref = _both(None, None, SIGNATURES[name])
    assert got == ref
    if name in EXPECTED:
        assert got[:3] == EXPECTED[name]


def test_default_table_path_is_the_committed_table():
    assert pt.DEFAULT_TABLE_PATH == rt.DEFAULT_TABLE_PATH
    assert pt.TABLE_SCHEMA == rt.TABLE_SCHEMA
    assert pt.CADENCE_SAFE_BANDS == rt.CADENCE_SAFE_BANDS
    for scout in (False, True):
        for r in (0, 4):
            assert pt.hand_cadence_defaults(scout, r) \
                == rt.hand_cadence_defaults(scout, r)


def _entry(args, device="cpu", exit_frac=0.90, suspend_frac=0.65):
    """tests/test_tune.py's entry shape, keyed by the reference."""
    return {"schema": rt.ENTRY_SCHEMA, "signature": _sigs(args)[1],
            "device_kind": device,
            "knobs": {"exit_frac": exit_frac, "suspend_frac": suspend_frac},
            "baseline": {"tasks": 10, "kernel_steps": 10,
                         "lane_efficiency": 0.5},
            "provenance": {"trials": 2}}


def _table(*entries):
    t = None
    for e in entries:
        t = rt.update_table(t, e)
    return t


NEAREST_CASES = {
    # hard constraints never cross, whatever the score
    "hard_constraints": ([VARIANTS[k] for k in ("f64-ikr", "scout-xla",
                                               "mesh8", "theta64",
                                               "simpson")], "base"),
    # a family match beats eps proximity ...
    "family_beats_eps": ([VARIANTS["eps-9"], VARIANTS["sin_scaled"]],
                         "base"),
    # ... and among same-family rows the smaller eps distance wins
    "closer_eps": ([VARIANTS["eps-9"], VARIANTS["eps-8"]], "base"),
    # nothing in common: score 0 falls through
    "score_floor": ([VARIANTS["sin_scaled_eps-12"]], "base"),
    # an exact (score, distance) tie: the smaller key wins
    "tie_break": ([VARIANTS["cosh4"], VARIANTS["sin_scaled"]], "quad"),
}


@pytest.mark.parametrize("case", sorted(NEAREST_CASES))
@pytest.mark.parametrize("device", ["cpu", "tpu-v5e"])
def test_nearest_entry_equals_reference(case, device):
    rows, probe = NEAREST_CASES[case]
    entries = _table(*[_entry(a) for a in rows])["entries"]
    p_sig, r_sig = _sigs(VARIANTS[probe])
    got = pt.nearest_entry(entries, p_sig, device)
    ref = rt.nearest_entry(entries, r_sig, device)
    assert got == ref
    if device == "tpu-v5e" or case in ("hard_constraints", "score_floor"):
        assert got is None
    else:
        assert got is not None


TABLES = {
    "exact": lambda: _table(_entry(VARIANTS["base"])),
    "nearest": lambda: _table(_entry(VARIANTS["eps-9"])),
    "exit_out_of_band": lambda: _table(_entry(VARIANTS["base"],
                                              exit_frac=1.49)),
    "suspend_not_below_exit": lambda: _table(_entry(
        VARIANTS["base"], exit_frac=0.8, suspend_frac=0.8)),
    "other_device": lambda: _table(_entry(VARIANTS["base"],
                                          device="tpu-v5e")),
    "no_knobs": lambda: {"schema": rt.TABLE_SCHEMA, "entries": {
        "k": dict(_entry(VARIANTS["base"]), knobs=None)}},
}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("explicit", [(None, None), (0.77, 0.55),
                                      (None, 0.93), (0.9, None)])
def test_tmp_table_resolution_equals_reference(table_env, table, explicit):
    rt.write_table(table_env, TABLES[table]())
    pt.clear_table_cache()
    got, ref = _both(*explicit, VARIANTS["base"])
    assert got == ref
    if explicit == (None, None):
        assert got[2] == {"exact": "exact", "nearest": "nearest"}.get(
            table, "default")


@pytest.mark.parametrize("content", [
    None,                                        # no file
    "{not json",                                 # malformed
    json.dumps({"schema": "another-schema", "entries": {}}),
    json.dumps({"schema": rt.TABLE_SCHEMA, "entries": []}),
    json.dumps([1, 2, 3]),
])
def test_missing_or_malformed_table_degrades_to_hand_tier(table_env,
                                                         content):
    if content is not None:
        with open(table_env, "w", encoding="utf-8") as fh:
            fh.write(content)
    assert pt.load_tuning_table() is None
    got, ref = _both(None, None, VARIANTS["base"])
    assert got == ref == (0.95, 0.65, "default", None)


@pytest.mark.parametrize("off", ["off", "0", "", "none"])
def test_table_env_off_disables(committed_table, monkeypatch, off):
    monkeypatch.setenv("PPLS_TUNING_TABLE", off)
    assert pt.tuning_table_path() is None
    got, ref = _both(None, None, MOTIVATION["flagship"])
    assert got == ref == (0.95, 0.65, "default", None)


def test_table_cache_follows_mtime(table_env):
    rt.write_table(table_env, _table(_entry(VARIANTS["base"])))
    t1 = pt.load_tuning_table()
    assert pt.load_tuning_table() is t1
    rt.write_table(table_env, _table(_entry(VARIANTS["base"],
                                            exit_frac=0.85)))
    import os
    st = os.stat(table_env)
    os.utime(table_env, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    got = pt.resolve_cadence_tuned(None, None, True, 4,
                                   signature=_sigs(VARIANTS["base"])[0],
                                   device="cpu")
    assert got == (0.85, 0.65, "exact")


def test_device_kind_on_cpu_and_card(committed_table, monkeypatch):
    assert pt.device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.device_kind("cuda")
    # on the card the reference's rule names the kind; the committed
    # rows are keyed cpu, so the flagship resolves through the hand tier
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert pt.device_kind("cuda") == "nvidia-h100-80gb-hbm3"
    p_sig, _ = _sigs(MOTIVATION["flagship"])
    assert pt.resolve_cadence_tuned(None, None, True, 8, signature=p_sig,
                                    device="cuda") \
        == (0.95, 0.65, "default")


def test_family_name_of_matches_reference():
    for name in ("sin_recip_scaled", "sin_scaled", "cosh4_scaled",
                 "quad_scaled", "gauss_center"):
        assert family_name_of(get_family(name)) == name
    assert family_name_of(lambda x, th: x) is None


# ---------------------------------------------------------------------------
# the walker and the stream with the committed table on
# ---------------------------------------------------------------------------

FAM = "sin_recip_scaled"
THETA = 1.0 + np.arange(8) / 8.0
BOUNDS = (1e-2, 1.0)
EPS = 1e-6          # scout-ikr, band -6: the committed -7 row, "nearest"
KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=2, refill_slots=2,
          seg_iters=32, min_active_frac=0.05, scout_dtype="f32")


def test_walker_with_table_on_walks_the_reference_schedule(committed_table):
    ref = ref_walker(ref_family(FAM), ref_family_ds(FAM), THETA, BOUNDS,
                     EPS, **KW)
    assert rt.last_resolution()["tier"] == "nearest"
    got = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                  THETA, BOUNDS, EPS, device="cpu", **KW)
    assert got.metrics.tasks == ref.metrics.tasks
    assert got.cycles == ref.cycles
    assert got.kernel_steps == ref.kernel_steps
    assert np.array_equal(got.cycle_stats, ref.cycle_stats)
    assert np.array_equal(got.seg_stats, ref.seg_stats)
    assert np.array_equal(got.waste, ref.waste)
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9


def test_stream_with_table_on_walks_the_reference_schedule(committed_table):
    skw = dict(KW, slots=8, chunk=1 << 10)
    reqs = [(float(t), BOUNDS) for t in THETA]
    arr = [0] * len(reqs)
    ref_eng = RefStream(FAM, EPS, **skw)
    ref = ref_eng.run(reqs, arrival_phase=arr)
    eng = StreamEngine(FAM, EPS, device="cpu", **skw)
    got = eng.run(reqs, arrival_phase=arr)
    assert got.phases == ref.phases
    assert np.array_equal(got.phase_stats, ref.phase_stats)
    assert [c.rid for c in got.completed] == [c.rid for c in ref.completed]
    assert [c.retire_phase for c in got.completed] \
        == [c.retire_phase for c in ref.completed]
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    for e in (ref_eng, eng):
        assert e.telemetry.registry.value(
            "ppls_tuning_resolution", tier="nearest") == 1.0
