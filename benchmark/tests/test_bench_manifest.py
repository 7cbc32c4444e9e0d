"""``BENCHMARK.json`` against the benchmark contract's shape rules, and the
files the harness finds by name."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells_of(metric, manifest):
    return metric.get("workloads", [w["name"] for w in manifest["workloads"]])


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(manifest, section):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    for e in manifest[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(cells_of(m, manifest)) <= cells
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in cells_of(m, manifest):
            assert cell in cells_of(e2e[m["moves"]], manifest), (m["name"], cell)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in manifest["end_to_end"] if cell in cells_of(m, manifest)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in cells_of(m, manifest) for m in manifest["per_layer"])


def test_cells_and_configs(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        used.add(w["config"])
        with open(os.path.join(ROOT, "benchmark", "workloads", f"{w['name']}.json")) as f:
            traffic = json.load(f)
        assert traffic["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers", f"{traffic['driver']}.py"))
        assert traffic["limits"]
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["changed_from_source"])


def test_layers_named_in_perf(manifest):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in manifest["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]
