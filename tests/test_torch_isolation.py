"""The port stands alone: it imports no JAX and nothing of monoforce_tpu,
yet its own copies of the config and robot presets give the JAX package's
contact clouds, masks and constants exactly, and its robot model carries
the JAX robot's parameters across bit for bit."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.convert import ROBOT_LEAVES, robot_model_from_arrays
from monoforce_tpu_torch.physics.engine import RobotModel

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import monoforce_tpu_torch
names = [m.name for m in pkgutil.walk_packages(monoforce_tpu_torch.__path__,
                                              "monoforce_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "monoforce_tpu"
             or m.startswith("monoforce_tpu."))
built = (bool(sys.modules["monoforce_tpu_torch.native"]._state)
         or bool(sys.modules["monoforce_tpu_torch.ops._build"]._libs))
print(json.dumps({"imported": names, "bad": bad, "built": built}))
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO / "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["built"] is False     # nothing is built or loaded at import
    for mod in ("monoforce_tpu_torch.physics.fast",
                "monoforce_tpu_torch.planner.shooting",
                "monoforce_tpu_torch.ops.fk_step_cuda",
                "monoforce_tpu_torch.ops.interp_cuda",
                "monoforce_tpu_torch.losses",
                "monoforce_tpu_torch.training.fit_terrain",
                "monoforce_tpu_torch.ops.voxel_pool",
                "monoforce_tpu_torch.models.terrain_encoder.lss",
                "monoforce_tpu_torch.convert",
                "monoforce_tpu_torch.pipeline",
                "monoforce_tpu_torch.physics.terrain",
                "monoforce_tpu_torch.physics.engine",
                "monoforce_tpu_torch.training.trainer",
                "monoforce_tpu_torch.training.evaluator",
                "monoforce_tpu_torch.vis",
                "monoforce_tpu_torch.planner.navigator",
                "monoforce_tpu_torch.planner.controller",
                "monoforce_tpu_torch.transformations",
                "monoforce_tpu_torch.ops.heightmap",
                "monoforce_tpu_torch.utils.io",
                "monoforce_tpu_torch.utils.misc",
                "monoforce_tpu_torch.utils.data",
                "monoforce_tpu_torch.utils.locking",
                "monoforce_tpu_torch.utils.timing",
                "monoforce_tpu_torch.utils.profiling",
                "monoforce_tpu_torch.datasets.wildscenes",
                "monoforce_tpu_torch.datasets.coco",
                "monoforce_tpu_torch.datasets.camera",
                "monoforce_tpu_torch.datasets.augment",
                "monoforce_tpu_torch.datasets.rough",
                "monoforce_tpu_torch.native",
                "monoforce_tpu_torch.scripts.run",
                "monoforce_tpu_torch.scripts.train",
                "monoforce_tpu_torch.scripts.eval",
                "monoforce_tpu_torch.scripts.explore_data",
                "monoforce_tpu_torch.scripts.fit_terrain",
                "monoforce_tpu_torch.scripts.robot_control",
                "monoforce_tpu_torch.scripts.navigate",
                "monoforce_tpu_torch.examples.diff_physics",
                "monoforce_tpu_torch.examples.train_friction_head",
                "monoforce_tpu_torch.examples.inference_with_rough_data",
                "monoforce_tpu_torch.examples.explore_data",
                "monoforce_tpu_torch.examples.explore_robot_contacts",
                "monoforce_tpu_torch.examples.rgbd_data",
                "monoforce_tpu_torch.parallel",
                "monoforce_tpu_torch.parallel.sharding",
                "monoforce_tpu_torch.parallel.rollout",
                "monoforce_tpu_torch.parallel.data_parallel",
                "monoforce_tpu_torch.scripts.overfit_demo",
                "monoforce_tpu_torch.scripts.full_b0_sharded"):
        assert mod in res["imported"]


@pytest.mark.parametrize("robot", ["tradr", "marv", "husky"])
@pytest.mark.parametrize("preset", ["0.1", "0.11", "for_planner"])
def test_config_copies_agree(robot, preset):
    if preset == "for_planner":
        j, t = JaxPhysicsConfig.for_planner(robot), PhysicsConfig.for_planner(robot)
    else:
        v = float(preset)
        j = JaxPhysicsConfig(robot=robot, mesh_voxel_size=v)
        t = PhysicsConfig(robot=robot, mesh_voxel_size=v)
    assert np.array_equal(t.robot_points, j.robot_points)
    assert t.robot_points.dtype == j.robot_points.dtype == np.float32
    assert np.array_equal(t.driving_parts, j.driving_parts)
    assert t.robot_size == j.robot_size
    assert (t.robot_mass, t.damping) == (j.robot_mass, j.damping)
    assert t.to_dict() == j.to_dict()


def test_point_counts_pinned():
    """tests/test_fast.py pins P=148 for tradr at 0.1 m; the planner
    presets stay within the 64 points of the pair modes."""
    want = {"tradr": (148, 62), "marv": (138, 62), "husky": (202, 64)}
    for robot, (p_ref, p_plan) in want.items():
        assert PhysicsConfig(robot=robot, mesh_voxel_size=0.1).robot_points.shape[0] == p_ref
        assert PhysicsConfig.for_planner(robot).robot_points.shape[0] == p_plan


def test_yaml_round_trip(tmp_path):
    cfg = PhysicsConfig.for_planner("marv", dt=0.02)
    cfg.robot_mass = 55.0
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(str(path))
    back = PhysicsConfig.from_yaml(str(path))
    assert back.to_dict() == cfg.to_dict()
    assert np.array_equal(back.robot_points, cfg.robot_points)


def test_robot_model_carried_across_bit_for_bit():
    jr = JaxRobotModel.from_config(JaxPhysicsConfig(robot="tradr",
                                                    mesh_voxel_size=0.1))
    leaves = {n: np.asarray(getattr(jr, n)) for n in ROBOT_LEAVES}
    tr = robot_model_from_arrays(leaves, jr.n_tracks, jr.has_flippers,
                                 jr.integration_mode, device="cpu")
    for n in ROBOT_LEAVES:
        assert np.array_equal(getattr(tr, n).numpy(), leaves[n]), n
    assert (tr.n_tracks, tr.has_flippers, tr.integration_mode) == (
        jr.n_tracks, jr.has_flippers, jr.integration_mode)
    # the port's own model agrees up to the last bits of the 3x3 inverse
    own = RobotModel.from_config(PhysicsConfig(robot="tradr",
                                               mesh_voxel_size=0.1),
                                 device="cpu")
    for n in ROBOT_LEAVES:
        np.testing.assert_allclose(getattr(own, n).numpy(), leaves[n],
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    with pytest.raises(KeyError):
        robot_model_from_arrays({}, 2, False, "euler", device="cpu")
    with pytest.raises(TypeError):
        robot_model_from_arrays({**leaves, "mass": np.float64(40.0)}, 2,
                                False, "euler", device="cpu")
    assert isinstance(tr.points, torch.Tensor)
