"""The plain reference under ``portbench/reference/`` against the program
on the CPU at tiny sizes (where the program runs its plain versions):
each cell's check reads no gap, and the run comes out correct with the
cell's own limits."""

from __future__ import annotations

import pytest

from conftest import run_cell

CELLS = ("tick.tradr", "shoot.tradr-4096", "train.marv-b24")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(tiny, cell):
    manifest, spec = tiny(cell)
    out = run_cell(manifest, spec, cell)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] == 0.0, (name, c)


def test_tick_heads_carry_signal(tiny):
    """Every head of the seeded encoder is alive (a ReLU head that is zero
    everywhere would compare nothing)."""
    manifest, spec = tiny("tick.tradr")
    out = run_cell(manifest, spec, "tick.tradr")
    assert out["info"]["least_head_mean_abs"] > 1e-3
