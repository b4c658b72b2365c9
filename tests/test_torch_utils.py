"""The port's host utilities on the CPU: ``Timer`` and ``timing``,
``measure`` and ``trace`` over ``torch.profiler``, and the file-locked CSV
helpers against the JAX package's (the same files, byte for byte)."""

import importlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from monoforce_tpu.utils import locking as jlocking
from monoforce_tpu.utils import misc as jmisc
from monoforce_tpu_torch import utils
from monoforce_tpu_torch.utils import locking, misc

# the module, which the package's ``timing`` decorator hides
timing_mod = importlib.import_module("monoforce_tpu_torch.utils.timing")


def test_timer_and_timing(capsys):
    x = torch.ones(64, 64)
    with utils.Timer("matmul", verbose=True) as t:
        y = t.block_on({"y": [x @ x], "n": 3})
    assert t.dt > 0 and float(y["y"][0][0, 0]) == 64.0
    assert "matmul took" in capsys.readouterr().out

    @utils.timing
    def slow(a):
        time.sleep(0.01)
        return a + 1

    assert slow(1) == 2
    out = capsys.readouterr().out
    assert out.startswith("slow took") and float(out.split()[2]) >= 0.01


def test_synchronize_waits_only_for_cuda(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)

    class Fake:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(timing_mod, "_tensors", lambda tree: iter(tree))
    timing_mod.synchronize([Fake(), Fake(), torch.zeros(1)])
    assert seen == [torch.device("cuda", 1)]


def test_measure_on_the_cpu():
    calls = []

    def fn(a):
        calls.append(1)
        time.sleep(0.002)
        return a * 2

    ms = utils.measure(fn, torch.ones(8), reps=3, warmup=2)
    assert len(calls) == 5 and 2.0 <= ms < 1000.0
    ms = utils.measure(fn, torch.ones(8), reps=2, warmup=0, transfer=True)
    assert len(calls) == 8 and ms >= 2.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "profile")
    a = torch.randn(32, 32)
    with utils.trace(log_dir) as prof:
        (a @ a).sum()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in ev.key for ev in prof.key_averages())


def test_csv_helpers_match_jax(tmp_path):
    rows = [(1, 2.5, "a"), (2, np.float32(0.125), "b")]
    for mod, name in ((locking, "t"), (jlocking, "j")):
        mod.write_to_csv(str(tmp_path / f"{name}_w.csv"), "x,y,z", rows)
        mod.append_to_csv(str(tmp_path / f"{name}_a.csv"), rows[:1],
                          header="x,y,z")
        mod.append_to_csv(str(tmp_path / f"{name}_a.csv"), rows[1:],
                          header="x,y,z")
    for kind in ("w", "a"):
        got = (tmp_path / f"t_{kind}.csv").read_text()
        assert got == (tmp_path / f"j_{kind}.csv").read_text()
        assert got == "x,y,z\n1,2.5,a\n2,0.125,b\n"


def test_path_lock_serialises_appends(tmp_path):
    """Appends from 8 threads under the lock, with a short switch interval:
    every row lands whole and the header once."""
    import sys

    path = str(tmp_path / "sub" / "log.csv")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            for i in range(25):
                utils.append_to_csv(path, [(k, i, "x" * 50)], header="k,i,s")

        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    lines = open(path).read().splitlines()
    assert lines[0] == "k,i,s" and len(lines) == 1 + 8 * 25
    assert sorted(tuple(map(int, ln.split(",")[:2])) for ln in lines[1:]) == [
        (k, i) for k in range(8) for i in range(25)]
    assert os.path.exists(path + ".lock")


@pytest.mark.parametrize("q", [(0.0, 1.0), (0.05, 0.95)])
def test_misc_matches_jax(q):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(40, 30))
    assert np.array_equal(misc.normalize(x, *q), jmisc.normalize(x, *q))
    cloud = np.zeros(10, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                ("intensity", "f4")])
    cloud["x"], cloud["z"] = np.arange(10), -np.arange(10)
    assert np.array_equal(misc.position(cloud), jmisc.position(cloud))
    plain = rng.normal(size=(5, 3))
    assert misc.position(plain) is plain
