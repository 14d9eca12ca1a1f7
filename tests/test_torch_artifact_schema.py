"""The port's bench-record and graftlint validators
(``ppls_tpu_torch/utils/artifact_schema.py``: ``validate_record``,
``validate_artifact_text``, ``_scan_lines``, ``validate_graftlint_json``,
``validate_graftlint_text``, ``ArtifactSchemaError``) against the JAX
package's.

The cases of tests/test_artifact_schema.py run through both packages'
validators (parametrised over the two), and each case's outcome and
message must be the same in both. ``validate_artifact_text`` gives the
same problem lists in both over the repo's ``BENCH_r*.json`` and
``MULTICHIP_r*.json`` (read only), and the graftlint validators the same
lists on a ledger of the committed shape and on broken ones.
"""

import copy
import glob
import json
import os

import pytest

from ppls_tpu.utils import artifact_schema as RA
from ppls_tpu_torch.utils import artifact_schema as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"reference": RA, "port": TA}

GOOD = {"metric": "subintervals evaluated/sec/chip", "value": 1.5e9,
        "unit": "subintervals/s/chip", "vs_baseline": 101.0}

BROKEN = [
    {"value": 1.0, "unit": "u", "vs_baseline": 0.0},          # no metric
    {"metric": "m", "unit": "u", "vs_baseline": 0.0},         # no value
    {"metric": "m", "value": float("nan"), "unit": "u",
     "vs_baseline": 0.0},                                     # NaN value
    {"metric": "m", "value": "12", "unit": "u",
     "vs_baseline": 0.0},                                     # str value
    {"metric": "m", "value": 1.0, "vs_baseline": 0.0},        # no unit
    {"metric": "m", "value": 1.0, "unit": "u"},               # no ratio
    "not an object",
    {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 1.0,
     "error": 3},                                             # bad error
    dict(GOOD, secondary=[]),                                 # not a dict
    dict(GOOD, secondary={"2d": 3}),
    dict(GOOD, secondary={"2d": {"value": 1.0}}),             # no metric
]


def _outcome(pkg, fn, *args, **kw):
    """(ok, value or the error's message) of ``fn`` in ``pkg``."""
    try:
        return True, getattr(pkg, fn)(*args, **kw)
    except pkg.ArtifactSchemaError as e:
        return False, str(e)


def _same(fn, *args, **kw):
    """The outcome in both packages, held equal; returns it."""
    out = {k: _outcome(p, fn, *copy.deepcopy(args), **kw)
           for k, p in PACKAGES.items()}
    assert out["port"] == out["reference"], out
    return out["port"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_record_accepts_good(pkg):
    P = PACKAGES[pkg]
    assert P.validate_record(dict(GOOD)) == GOOD
    assert _same("validate_record", dict(GOOD)) == (True, GOOD)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_record_accepts_failure_value(pkg):
    # 0.0 is the legitimate failure value; error records may omit the
    # baseline ratio
    P = PACKAGES[pkg]
    for rec in ({"metric": "m", "value": 0.0, "unit": "u",
                 "vs_baseline": 0.0, "error": "boom"},
                {"metric": "m", "value": 0.0, "unit": "u",
                 "error": "boom"}):
        assert P.validate_record(dict(rec)) == rec
        assert _same("validate_record", rec)[0]


@pytest.mark.parametrize("broken", BROKEN)
@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_record_rejects_broken(pkg, broken):
    P = PACKAGES[pkg]
    with pytest.raises(P.ArtifactSchemaError):
        P.validate_record(copy.deepcopy(broken))
    ok, msg = _same("validate_record", broken, where="rec")
    assert not ok and msg.startswith("rec")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_record_secondary_poison(pkg):
    P = PACKAGES[pkg]
    rec = dict(GOOD, secondary={"2d": {"metric": "2d",
                                       "value": float("nan")}})
    with pytest.raises(P.ArtifactSchemaError, match="secondary.2d"):
        P.validate_record(rec)
    assert not _same("validate_record", rec)[0]
    rec = dict(GOOD, secondary={"2d": {"error": "failed"},
                                "qmc": {"skipped": "no tpu"}})
    P.validate_record(rec)          # error/skipped secondaries pass
    assert _same("validate_record", rec)[0]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_artifact_wrapper_shape(pkg):
    # a round's wrapper object: records live as JSON lines inside the
    # "tail" string
    P = PACKAGES[pkg]
    wrapper = {"n": 8, "rc": 0,
               "tail": "some log line\n" + json.dumps(GOOD) + "\n"}
    assert P.validate_artifact_text(json.dumps(wrapper)) == []
    # a garbled record inside the tail is caught
    bad = json.dumps(GOOD)[:-20] + "..."
    wrapper["tail"] = bad + "\n"
    problems = P.validate_artifact_text(json.dumps(wrapper))
    assert problems and "unparseable" in problems[0]
    assert _same("validate_artifact_text", json.dumps(wrapper)) \
        == (True, problems)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_artifact_raw_stream(pkg):
    P = PACKAGES[pkg]
    text = "log\n" + json.dumps(GOOD) + "\n"
    assert P.validate_artifact_text(text) == []
    assert P.validate_artifact_text("nothing here\n") \
        == ["artifact: no bench records found"]
    assert P.validate_artifact_text("nothing here\n",
                                    require_records=False) == []
    broken = "\n".join(json.dumps(b) for b in BROKEN[:6]) + "\n{\"metric\""
    assert _same("validate_artifact_text", broken, where="s") \
        == (True, P.validate_artifact_text(broken, where="s"))
    assert len(P.validate_artifact_text(broken, where="s")) == 6


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_scan_lines_counts_records_and_problems(pkg):
    P = PACKAGES[pkg]
    text = "\n".join(["x", json.dumps(GOOD), '{"other": 1}',
                      json.dumps(BROKEN[2]), '{"metric": "m", "val'])
    problems, found = P._scan_lines(text, "w")
    assert found == 2 and len(problems) == 2
    assert (problems, found) == RA._scan_lines(text, "w") \
        == TA._scan_lines(text, "w")


def test_committed_artifacts_same_problems_in_both():
    # the repo's round artifacts, read only: the same lists, record
    # requirement as check_artifacts sets it
    paths = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json"))
                   + glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json")))
    assert paths
    for p in paths:
        with open(p) as fh:
            text = fh.read()
        base = os.path.basename(p)
        kw = dict(where=base, require_records=base.startswith("BENCH"))
        assert TA.validate_artifact_text(text, **kw) \
            == RA.validate_artifact_text(text, **kw), base


def _ledger():
    """A graftlint ``--format json`` ledger of the committed shape: one
    new and one grandfathered record, a stale key, counts that
    reconcile."""
    return {
        "schema": "graftlint-v1", "target": "ppls_tpu", "deep": True,
        "runtime": False,
        "violations": [
            {"key": "GL02:pkg/a.py:f:float32", "code": "GL02",
             "tier": "ast", "path": "pkg/a.py", "line": 3,
             "symbol": "f:float32", "message": "m",
             "grandfathered": False},
            {"key": "GL07:pkg/b.py:g", "code": "GL07", "tier": "deep",
             "path": "pkg/b.py", "line": 9, "symbol": "g",
             "message": "census", "grandfathered": True,
             "reason": "reviewed: fixture"}],
        "stale": ["GL01:pkg/c.py:h"],
        "counts": {"total": 2, "new": 1, "grandfathered": 1, "stale": 1},
        "ok": False}


def _broken_ledgers():
    out = ["not a ledger", {"schema": "x"}]
    for change in (
            lambda d: d.update(ok=True),
            lambda d: d["counts"].update(new=2),
            lambda d: d.update(runtime="no"),
            lambda d: d["violations"][0].update(code="X1"),
            lambda d: d["violations"][0].update(tier="jit"),
            lambda d: d["violations"][0].update(key="GL02:elsewhere"),
            lambda d: d["violations"][1].pop("reason"),
            lambda d: d["violations"].append(7),
            lambda d: d.update(stale=[1]),
            lambda d: d.update(violations={})):
        d = _ledger()
        change(d)
        out.append(d)
    return out


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_graftlint_validators_same_in_both(pkg):
    P = PACKAGES[pkg]
    assert P.validate_graftlint_json(_ledger()) == []
    assert P.validate_graftlint_text(json.dumps(_ledger())) == []
    for doc in _broken_ledgers():
        got = P.validate_graftlint_json(doc, where="lint")
        assert got, doc
        assert got == RA.validate_graftlint_json(doc, where="lint") \
            == TA.validate_graftlint_json(doc, where="lint")
        text = json.dumps(doc)
        assert P.validate_graftlint_text(text) \
            == RA.validate_graftlint_text(text)
    bad = P.validate_graftlint_text("{not json")
    assert len(bad) == 1 and bad[0].startswith("graftlint: unparseable")
    assert bad == RA.validate_graftlint_text("{not json")
