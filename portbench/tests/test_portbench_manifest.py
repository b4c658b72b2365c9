"""BENCHMARK.json against the rules its format keeps, and every name in it
against the files that the harness finds by that name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert manifest["command"][0] == "python3"
    assert len(manifest["command"]) <= 32
    for p in manifest["paths"]:
        assert PATH.match(p) and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in manifest["command"][1:]:
        assert _line(word) and not word.startswith("/")
        assert any(word.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    n = 24   # the most cells any later PR may have
    runs = 2 + 14 * n
    assert runs * (manifest["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = set()
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not key.endswith(("_dim", "_rank")) and key not in (
                "camC", "final_dim", "n_sim_trajs", "contact_points")


def test_workloads(manifest):
    cells = manifest["workloads"]
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        traffic = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        limits = ROOT / "portbench" / "workloads" / f"{w['name']}.json"
        with open(traffic) as f:
            driver = json.load(f)["driver"]
        assert (ROOT / "portbench" / "drivers" / f"{driver}.py").exists()
        with open(limits) as f:
            checks = json.load(f)["checks"]
        assert checks and all(v > 0 for v in checks.values())


def _reported(manifest, cell):
    return {m["name"] for m in manifest["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_metrics(manifest):
    e2e, layers = manifest["end_to_end"], manifest["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    cells = {w["name"] for w in manifest["workloads"]}
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        # every cell that reports the metric reports what it moves
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in _reported(manifest, cell)
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        # each cell: setup_s, another end-to-end metric, a per-layer one
        assert "setup_s" in _reported(manifest, cell)
        assert len(_reported(manifest, cell)) >= 2
        assert any(cell in m.get("workloads", cells) for m in layers)
    # one layer name per layer, letter for letter
    assert {m["layer"] for m in layers} == {
        "terrain encoder", "serving rollout", "exact engine", "kernels",
        "device"}
