"""The port's trainer learns: ``scripts/overfit_demo.py`` on the CPU.

``overfit_demo.main`` on ``fixtures.make_sequence`` (4 frames) with
``tiny_lss_cfg`` (tradr at 0.4 m over 1 s, batch 2) at the staged recipe
of tests/test_trainer.py::test_overfit_converges (30 heightmap-only steps
at lr 1e-3, then 30 steps with the physics term at lr 1e-4), held to that
test's gates, not to JAX's loss values (its docstring records that whole
runs' losses depend on rounding context): the warm total falls 5x and its
terrain and geom losses fall; the physics stage stays finite with no 3x
spike, and its physics and total losses fall 2x.  The run writes one
``losses.jsonl`` row a step, and ``--save-ckpt`` a checkpoint that the
port's ``scripts/eval.py`` loads strictly.  The 60 steps take ~90 s here
(~1.2 s a warm step and ~1.7 s a physics step in one thread).
"""

import json
import os

import numpy as np
import pytest

from fixtures import make_sequence, tiny_lss_cfg
from monoforce_tpu_torch.config import LSSConfig
from monoforce_tpu_torch.scripts import eval as eval_script
from monoforce_tpu_torch.scripts import overfit_demo

WARM, STEPS = 30, 30
GATES = ("warm total falls 5x", "warm terrain falls", "warm geom falls",
         "phys stage finite", "phys stage no 3x spike", "phys falls 2x",
         "phys stage total falls 2x")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overfit"))
    seq = make_sequence(root, n_frames=4)
    lss = tiny_lss_cfg()
    cfg = os.path.join(root, "tiny_lss.yaml")
    LSSConfig(data_aug_conf=lss["data_aug_conf"], grid_conf=lss["grid_conf"],
              soft_classes=lss["soft_classes"]).to_yaml(cfg)
    out = os.path.join(root, "out")
    ckpt = os.path.join(root, "overfit.pth")
    summary = overfit_demo.main(
        ["--sequence", seq, "--lss_cfg_path", cfg, "--staged", str(WARM),
         "--steps", str(STEPS), "--out", out, "--save-ckpt", ckpt,
         "--device", "cpu"])
    return dict(root=root, cfg=cfg, out=out, ckpt=ckpt, summary=summary)


@pytest.mark.parametrize("gate", GATES)
def test_staged_overfit_meets_the_jax_gates(run, gate):
    gates = run["summary"]["staged"]["gates"]
    assert set(gates) == set(GATES)
    assert gates[gate], (gate, run["summary"]["staged"])


def test_losses_written_per_step(run):
    with open(os.path.join(run["out"], "losses.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == WARM + STEPS
    assert [r["stage"] for r in rows] == ["warm"] * WARM + ["phys"] * STEPS
    assert [r["step"] for r in rows] == list(range(WARM + STEPS))
    assert all(r["phys"] == 0.0 for r in rows[:WARM])
    assert np.isfinite([r[k] for r in rows
                        for k in ("total", "geom", "terrain", "phys")]).all()
    with open(os.path.join(run["out"], "summary.json")) as f:
        assert json.load(f)["staged"]["gates"] == run["summary"]["staged"][
            "gates"]


def test_checkpoint_loads_in_eval(run):
    """The saved state_dict is the trained model: scripts/eval.py loads it
    strictly and evaluates the sequence's validation split."""
    means = eval_script.main(
        ["--data_dir", run["root"], "--checkpoint", run["ckpt"],
         "--lss_cfg_path", run["cfg"], "--robot", "tradr",
         "--traj_sim_time", "1.0", "--out_dir",
         os.path.join(run["root"], "eval"), "--device", "cpu"])
    assert means and all(np.isfinite(v) for v in means.values())
