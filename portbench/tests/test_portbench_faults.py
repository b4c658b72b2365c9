"""Each fault that a cell can have, planted in the program underneath a
whole run (the look for a card skipped, the CPU at a tiny size), turns
``correct`` false: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced.  The exchange
between chips is no fault of these one-chip cells."""

from __future__ import annotations

import pytest
import torch

from conftest import run_cell


def _unchanged_state(monkeypatch):
    from monoforce_tpu_torch.physics import fast
    monkeypatch.setattr(fast, "_integrate", lambda state18, acc8, dt: state18)


def _half_batch(monkeypatch):
    """The rollout of the first half of the trajectories, given for all."""
    from monoforce_tpu_torch.physics import fast
    orig = fast.planner_rollout

    def half(robot, z_grid, controls, **kw):
        n = controls.shape[0]
        states, stats = orig(robot, z_grid, controls[:n // 2], **kw)

        def twice(t):
            return torch.cat([t, t[:n - n // 2]], dim=0)
        return (type(states)(*map(twice, states)),
                type(stats)(*map(twice, stats)))
    monkeypatch.setattr(fast, "planner_rollout", half)


def _altered_cost(monkeypatch):
    """One path's cost moved by half where the costs are produced."""
    from monoforce_tpu_torch.planner import shooting
    orig = shooting.force_variance_cost

    def altered(spring_std_t):
        c = orig(spring_std_t).clone()
        c[0] = c[0] * 1.5
        return c
    monkeypatch.setattr(shooting, "force_variance_cost", altered)


def _altered_choice(monkeypatch):
    """The chosen index moved by half the batch where it is produced."""
    from monoforce_tpu_torch.planner import shooting
    orig = shooting._plan

    def altered(*args, **kwargs):
        r = orig(*args, **kwargs)
        n = r.costs.shape[0]
        return r._replace(best=(r.best + n // 2) % n)
    from monoforce_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "_plan", altered)


def _no_update(monkeypatch):
    from monoforce_tpu_torch.training import trainer
    monkeypatch.setattr(trainer.GradientChain, "step", lambda self: None)


def _from_window(monkeypatch, plant):
    """``plant`` put in only from the fourth train step on: the window's
    steps, after the three that set-up runs (as a step that changes its
    path once warm, such as a captured graph, would)."""
    from monoforce_tpu_torch.training import trainer
    orig = trainer.make_train_step

    def make(*args, **kwargs):
        train_step, eval_step = orig(*args, **kwargs)
        calls = {"n": 0}

        def counted(*a, **k):
            calls["n"] += 1
            if calls["n"] == 4:
                plant(monkeypatch)
            return train_step(*a, **k)
        return counted, eval_step
    monkeypatch.setattr(trainer, "make_train_step", make)


def _no_update_in_window(monkeypatch):
    _from_window(monkeypatch, _no_update)


def _half_train_batch_in_window(monkeypatch):
    _from_window(monkeypatch, _half_train_batch)


def _half_train_batch(monkeypatch):
    from monoforce_tpu_torch.training import trainer
    orig = trainer.compute_losses

    def half(model, robot, batch, *args, **kwargs):
        return orig(model, robot, tuple(b[:b.shape[0] // 2] for b in batch),
                    *args, **kwargs)
    monkeypatch.setattr(trainer, "compute_losses", half)


def _altered_loss(monkeypatch):
    """The heightmap losses moved by 1% where they are produced."""
    from monoforce_tpu_torch.training import trainer
    orig = trainer.hm_loss
    monkeypatch.setattr(trainer, "hm_loss",
                        lambda *a, **k: orig(*a, **k) * 1.01)


FAULTS = [
    ("tick.tradr", _unchanged_state), ("tick.tradr", _half_batch),
    ("tick.tradr", _altered_cost), ("tick.tradr", _altered_choice),
    ("shoot.tradr-4096", _unchanged_state),
    ("shoot.tradr-4096", _half_batch), ("shoot.tradr-4096", _altered_cost),
    ("train.marv-b24", _no_update), ("train.marv-b24", _half_train_batch),
    ("train.marv-b24", _altered_loss),
    ("train.marv-b24", _no_update_in_window),
    ("train.marv-b24", _half_train_batch_in_window),
]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny, monkeypatch, cell, plant):
    manifest, spec = tiny(cell)
    plant(monkeypatch)
    out = run_cell(manifest, spec, cell)
    assert not out["correct"], out["checks"]
