"""On the card, at each cell's own sizes: the program comes out correct,
and what stands in its place one precision lower (the control), or with
a planted fault, does not.  Skips without a CUDA device; with a card:
``python -m pytest portbench/tests -m cuda -q``."""

from __future__ import annotations

import copy

import pytest

from conftest import run_cell

pytestmark = pytest.mark.cuda

CELLS = ("tick.tradr", "shoot.tradr-4096", "train.marv-b24")
STAND_INS = (("tick.tradr", "control"), ("tick.tradr", "altered_answer"),
             ("shoot.tradr-4096", "control"), ("train.marv-b24", "control"),
             ("train.marv-b24", "half_batch"))


def _spec(cell):
    from portbench import harness
    manifest = harness.load_manifest()
    spec = copy.deepcopy(harness.cell_spec(manifest, cell))
    # the compared units among the first few (the train cell's checked
    # step the first), so that a short window reaches them
    train = spec["traffic"]["driver"] == "train"
    spec["limits"].update(check_units=2, check_within=1 if train else 3)
    return manifest, spec


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    manifest, spec = _spec(cell)
    out = run_cell(manifest, spec, cell, seconds=3.0, device=card)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,system", STAND_INS)
def test_stand_in_is_not_correct(card, cell, system):
    manifest, spec = _spec(cell)
    out = run_cell(manifest, spec, cell, seconds=3.0, device=card,
                   system=system)
    assert not out["correct"], out["checks"]
