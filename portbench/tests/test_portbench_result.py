"""The result line's schema, and the command's exits without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT, run_cell


def test_result_schema(tiny):
    manifest, spec = tiny("shoot.tradr-4096")
    out = run_cell(manifest, spec, "shoot.tradr-4096")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out)
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
    assert set(out["metrics"]) == {"traj_per_s", "setup_s"}
    for k, v in out["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in out["device"]
    for k, c in out["checks"].items():
        assert set(c) == {"value", "limit"}


def test_traced_result_has_layers(tiny):
    """A traced run reports the cell's per-layer metrics; on the CPU the
    profile holds no device operation, so the metrics read from it (and
    the breakdown) are left out rather than read as 0."""
    manifest, spec = tiny("tick.tradr")
    out = run_cell(manifest, spec, "tick.tradr", trace_on=True)
    assert {"encoder_ms.tick", "plan_ms.tick", "mfu.tick"} <= set(
        out["metrics"])
    assert "idle_share.tick" not in out["metrics"]
    assert "breakdown" not in out and "busy_s" not in out["device"]


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tick.tradr", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tick.tradr", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
