"""No run may load JAX or the JAX package: the guard compares whole
top-level names, and the reference loads nothing of the program."""

from __future__ import annotations

import subprocess
import sys
import types

from conftest import ROOT


def test_guard_compares_whole_top_level_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "monoforce_tpu_torch_x",
                        types.ModuleType("monoforce_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    for name in ("jax.numpy", "monoforce_tpu", "monoforce_tpu.physics",
                 "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["flax", "jax", "jaxlib",
                                           "monoforce_tpu"]


def test_run_refuses_a_loaded_jax(monkeypatch, capsys):
    """The command prints no result and exits non-zero once JAX is
    loaded, before it looks for a card."""
    sys.path.insert(0, str(ROOT / "portbench"))
    import run
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "tick.tradr", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import portbench.reference as r
for m in pkgutil.iter_modules(r.__path__):
    importlib.import_module("portbench.reference." + m.name)
bad = sorted({{n.split(".")[0] for n in sys.modules}} & {{
    "jax", "jaxlib", "flax", "monoforce_tpu", "monoforce_tpu_torch"}})
print(bad)
sys.exit(1 if bad else 0)
"""


def test_reference_loads_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", CHECK.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_harness_loads_no_jax():
    """The harness, its drivers and the program they import load neither
    JAX nor the JAX package."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r});"
            "import portbench.harness, portbench.drivers.tick,"
            "portbench.drivers.shoot, portbench.drivers.train;"
            "import monoforce_tpu_torch.pipeline,"
            "monoforce_tpu_torch.training,"
            "monoforce_tpu_torch.physics.fast;"
            "from portbench.harness import forbidden_modules;"
            "sys.exit(1 if forbidden_modules() else 0)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
