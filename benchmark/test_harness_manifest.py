"""The manifest and the harness's files: names, units, the metrics each
cell reports, the share of four-chip cells, and what the benchmark's
modules import. CPU only."""

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "ppls_tpu"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_and_units(manifest):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                if text is not None:
                    assert 1 <= len(text) <= 200 and "\n" not in text
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [n for k, n in names if k == key]
        assert len(got) == len(set(got)), key
    metrics = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_cells_and_configs(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           f"{w['traffic']}.json"))
    assert used == set(configs)
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg


def test_four_chip_share(manifest):
    cells = manifest["workloads"]
    four = sum(1 for w in cells if w["chips"] == 4)
    assert four <= max(1, len(cells) // 4)


def test_every_cell_reports_what_its_metrics_move(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")

    def reports(cell, metric):
        w = e2e[metric].get("workloads")
        return w is None or cell in w

    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, m["moves"]), m["name"]
    for cell in cells:
        assert reports(cell, "setup_s")
        assert any(reports(cell, n) for n in e2e if n != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py")), m["name"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def _sources():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    paths = [os.path.join(HERE, "reference.py")] + [
        os.path.join(HERE, "integrands", f)
        for f in os.listdir(os.path.join(HERE, "integrands"))
        if f.endswith(".py")]
    for path in paths:
        for mod in _imports(path):
            assert mod.split(".")[0] in ("torch", "importlib", "os",
                                         "typing", "__future__"), (path, mod)


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys
    import types
    sys.path.insert(0, HERE)
    import run
    for name in ("ppls_tpu_torch_probe", "ppls_tpu_torch_probe.sub",
                 "jaxlike"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(run.forbidden_modules()) & {"ppls_tpu", "jaxlike"}
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()
