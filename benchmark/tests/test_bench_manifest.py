"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(manifest["command"]) <= 32
    for word in manifest["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(manifest):
    for w in manifest["workloads"]:
        res = harness.resolve(manifest, w["name"])
        e2e = {m["name"] for m in res["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert res["per_layer"], w["name"]
        for m in res["per_layer"]:
            assert w["name"] in m.get("workloads", [w["name"]])


@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.load_manifest()["workloads"]])
def test_cell_resolves_by_name(workload):
    res = harness.resolve(harness.load_manifest(), workload)
    for fn in ("setup", "window", "check", "trace_slice", "control"):
        assert callable(getattr(res["driver"], fn))
    for name, mod in res["readers"].items():
        assert callable(mod.read), name
    assert res["limits"], f"benchmark/limits/{workload}.json"
    cfg = res["cfg"]
    assert cfg["name"] == res["cell"]["config"]


def test_config_files_are_distinct_and_unreduced(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []


def test_new_files_resolve_without_edits(tmp_path):
    """A later change adds a configuration, a mix and a metric as new
    files and manifest entries alone."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    man = harness.load_manifest()
    (tmp_path / "benchmark/traffic/crowd32.json").write_text(json.dumps(
        dict(json.loads((ROOT / "benchmark/traffic/bulk32.json")
                        .read_text()), lam=5.0)))
    (tmp_path / "benchmark/metrics/ladder_share.py").write_text(
        "def read(rec):\n    return None\n")
    man["workloads"].append({"name": "b16w8a.crowd32",
                             "config": "yolov8s-vitb16-w8a",
                             "traffic": "crowd32", "chips": 1, "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("b16w8a.crowd32")
    man["per_layer"].append({"name": "ladder_share", "unit": "%",
                             "better": "lower", "source": "host_clock",
                             "layer": "runner", "moves": "frames_per_s",
                             "workloads": ["b16w8a.crowd32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    res = harness.resolve(harness.load_manifest(tmp_path), "b16w8a.crowd32",
                          tmp_path)
    assert res["mix"]["lam"] == 5.0
    assert "ladder_share" in res["readers"]
    assert Path(res["driver"].__file__).parent.name == "drivers"
