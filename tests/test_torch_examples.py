"""The port's examples against the JAX package, on the CPU.

Each test feeds both sides the same numpy draws, at small sizes:

- ``diff_physics``: tradr's 0.11 m cloud on the 128 x 128 hill, the JAX
  ``generate_controls(PRNGKey(0))`` for 4 trajectories over 1 s: exact and
  fast positions within 1e-4 m, costs within rtol 1e-4 and the same
  argmin, the terrain gradient over 2 trajectories within 1e-3 of its
  largest entry (100 steps of BPTT in two float32 backends).
- ``train_friction_head``: the flax head's parameters carried across by
  ``load_flax_params`` (its forward within 1e-6), then 3 Adam steps at
  B=2 over 0.5 s on both sides: losses and head parameters within rtol
  1e-4.
- ``inference_with_rough_data``: a two-frame sequence from chip_smoke.py's
  writer at the tiny LSS config's image size (cameras off the ego axes),
  marv with 16 trajectories, the JAX encoder's seeded variables loaded
  with ``--weights``: heads within 1e-4; the mode pair3_muq.
- ``explore_robot_contacts``: clouds and masks equal; ``rgbd_data``: the
  cloud within 1e-6; ``explore_data``: the sample's arrays equal.
- Each example's ``main`` at small arguments, with ``--device cpu`` where
  it touches a device.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import chip_smoke
from fixtures import make_sequence, tiny_lss_cfg
from monoforce_tpu import robots as jrobots
from monoforce_tpu.config import LSSConfig as JaxLSSConfig
from monoforce_tpu.config import PhysicsConfig as JaxPhysicsConfig
from monoforce_tpu.datasets import ROUGH as JaxROUGH
from monoforce_tpu.datasets.camera import depth_to_cloud as jax_depth_to_cloud
from monoforce_tpu.losses import physics_loss as jax_physics_loss
from monoforce_tpu.physics import DPhysics as JaxDPhysics
from monoforce_tpu.physics import generate_controls as jax_generate_controls
from monoforce_tpu.physics.engine import RobotModel as JaxRobotModel
from monoforce_tpu.physics.engine import rollout as jax_rollout
from monoforce_tpu.physics.fast import fast_rollout as jax_fast_rollout
from monoforce_tpu.pipeline import MonoForce as JaxMonoForce
from monoforce_tpu.planner.shooting import force_variance_cost as jax_fvc
from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.convert import variables_to_state_dict
from monoforce_tpu_torch.examples import (diff_physics, explore_data,
                                          explore_robot_contacts,
                                          inference_with_rough_data,
                                          rgbd_data, train_friction_head)
from monoforce_tpu_torch.physics.engine import RobotModel
from monoforce_tpu_torch.physics.fast import fast_rollout, planner_kernel_mode
from test_torch_encoder import seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- diff_physics


def test_diff_physics_matches_jax():
    jcfg = JaxPhysicsConfig(robot="tradr")
    gx, gy = jcfg.grid_coords()
    z = jnp.asarray(0.5 * np.exp(-((gx - 2.0) ** 2) / 2 - gy ** 2 / 4),
                    jnp.float32)
    controls, _ = jax_generate_controls(jax.random.PRNGKey(0), n_trajs=4,
                                        time_horizon=1.0, dt=jcfg.dt)
    states, (f_spring, _) = JaxDPhysics(jcfg)(
        jnp.broadcast_to(z, (4,) + z.shape), controls)
    robot = JaxRobotModel.from_config(jcfg)
    fstates, stats = jax_fast_rollout(robot, z, controls)
    costs = np.asarray(jax_fvc(stats.spring_std))

    def loss(zg):
        s, _ = jax_fast_rollout(robot, zg, controls[:2])
        return jnp.mean(s.x[:, -1, 2])

    g = np.asarray(jax.jit(jax.grad(loss))(z))

    cfg = PhysicsConfig(robot="tradr")
    assert np.array_equal(diff_physics.hill(cfg), np.asarray(z))
    out = diff_physics.walkthrough(cfg, np.asarray(z), np.asarray(controls),
                                   "cpu", n_grad=2)
    assert out["f_spring"].shape == f_spring.shape
    np.testing.assert_allclose(out["states"].x.numpy(), np.asarray(states.x),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["fstates"].x.numpy(),
                               np.asarray(fstates.x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["costs"].numpy(), costs, rtol=1e-4)
    assert int(torch.argmin(out["costs"])) == int(costs.argmin())
    got = out["grad"].numpy()
    assert (got != 0).sum() > 50 and np.abs(g).max() > 0.01
    np.testing.assert_allclose(got, g, rtol=0, atol=1e-3 * np.abs(g).max())


# ------------------------------------------------------ train_friction_head


def test_train_friction_head_matches_jax():
    import flax.linen as nn

    class FlaxHead(nn.Module):
        @nn.compact
        def __call__(self, feats):
            h = nn.Conv(8, (3, 3))(feats)
            h = nn.relu(h)
            return nn.relu(nn.Conv(1, (1, 1))(h))[..., 0]

    B = 2
    jcfg = JaxPhysicsConfig(robot="tradr", grid_res=0.4, traj_sim_time=0.5)
    robot = JaxRobotModel.from_config(jcfg)
    H, W = jcfg.grid_shape
    n = jcfg.n_sim_steps
    gx, gy = jcfg.grid_coords()
    friction_true = jnp.asarray(0.2 + 0.8 * (gy < 0), jnp.float32)
    v, w = jnp.linspace(0.4, 1.0, B), jnp.linspace(-0.6, 0.6, B)
    controls = jnp.stack([jnp.tile(v[:, None], (1, n)),
                          jnp.tile(w[:, None], (1, n))], axis=-1)
    zb = jnp.zeros((B, H, W))
    gt, _, _ = jax_rollout(robot, zb, controls,
                           friction=jnp.broadcast_to(friction_true, (B, H, W)),
                           return_forces=False)
    ts = jnp.tile(jnp.linspace(0, jcfg.traj_sim_time, n)[None], (B, 1))
    feats = jnp.stack([jnp.asarray(gx) / jcfg.d_max,
                       jnp.asarray(gy) / jcfg.d_max], axis=-1)[None]
    head = FlaxHead()
    params = head.init(jax.random.PRNGKey(0), feats)

    def loss_fn(p):
        fr = head.apply(p, feats)[0]
        s, _, _ = jax_rollout(robot, zb, controls,
                              friction=jnp.broadcast_to(fr, (B, H, W)),
                              return_forces=False, bptt_grad_clip=1e3)
        return jax_physics_loss([s.x], [gt.x], ts, ts)

    opt = optax.adam(3e-2)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, s = opt.update(grads, s)
        return optax.apply_updates(p, upd), s, loss

    port = train_friction_head.load_flax_params(
        train_friction_head.FrictionHead(),
        jax.tree_util.tree_map(np.asarray, params))
    cfg = PhysicsConfig(robot="tradr", grid_res=0.4, traj_sim_time=0.5)
    _, t_feats, _, t_controls, t_gt, t_ts = train_friction_head.scene(
        cfg, "cpu", n_trajs=B)
    np.testing.assert_allclose(t_feats.numpy().transpose(0, 2, 3, 1),
                               np.asarray(feats), rtol=0, atol=1e-7)
    np.testing.assert_allclose(t_controls.numpy(), np.asarray(controls),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(t_ts.numpy(), np.asarray(ts), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(t_gt.numpy(), np.asarray(gt.x), rtol=0,
                               atol=1e-5)
    with torch.no_grad():
        fr0 = port(t_feats).numpy()
    np.testing.assert_allclose(fr0, np.asarray(head.apply(params, feats)),
                               rtol=0, atol=1e-6)
    assert fr0.mean() > 0.05         # a live head (ReLU heads can be dead)

    s = opt.init(params)
    jlosses = []
    for _ in range(3):
        params, s, loss = step(params, s)
        jlosses.append(float(loss))
    losses = train_friction_head.train(port, cfg, "cpu", n_iters=3,
                                       log_every=0, n_trajs=B)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    p = params["params"]
    for conv, name in ((port.conv1, "Conv_0"), (port.conv2, "Conv_1")):
        np.testing.assert_allclose(
            conv.weight.detach().numpy(),
            np.asarray(p[name]["kernel"]).transpose(3, 2, 0, 1), rtol=1e-4,
            atol=1e-6, err_msg=name)
        np.testing.assert_allclose(conv.bias.detach().numpy(),
                                   np.asarray(p[name]["bias"]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------ the ROUGH examples


@pytest.fixture(scope="module")
def rough(tmp_path_factory):
    """(the fixture sequence, the tiny LSS config as a dict and a YAML)."""
    seq = make_sequence(str(tmp_path_factory.mktemp("rough")), n_frames=2)
    lss = tiny_lss_cfg()
    path = str(tmp_path_factory.mktemp("cfg") / "tiny_lss.yaml")
    LSSConfig(data_aug_conf=lss["data_aug_conf"], grid_conf=lss["grid_conf"],
              soft_classes=lss["soft_classes"]).to_yaml(path)
    return seq, lss, path


def test_inference_with_rough_data_matches_jax(rough, tmp_path):
    """On chip_smoke.py's synthetic sequence at the tiny config's image
    size: its cameras sit off the ego axes, where the splat's cells do not
    hang on the last bit (the fixture's cameras look along the axes)."""
    _, lss, cfg_path = rough
    seq, _ = chip_smoke.write_rough_sequence(str(tmp_path / "data"), 2,
                                             (60, 80), 2000)
    dcfg = JaxPhysicsConfig(robot="marv")
    dcfg.n_sim_trajs = 16
    ds = JaxROUGH(seq, lss_cfg=lss, dphys_cfg=dcfg)
    inputs = [a[None] for a in ds.get_images_data(0)]
    mf = JaxMonoForce(dphys_cfg=dcfg, lss_cfg=JaxLSSConfig(
        data_aug_conf=lss["data_aug_conf"], grid_conf=lss["grid_conf"],
        soft_classes=lss["soft_classes"]))
    variables = seeded_variables(mf.model, inputs, seed=3)
    want = jax.jit(mf.model.apply)(variables, *map(jnp.asarray, inputs))
    weights = str(tmp_path / "lss.pth")
    torch.save(variables_to_state_dict(variables), weights)
    mode, terrain, plan = inference_with_rough_data.main(
        ["--sequence", seq, "--lss_cfg_path", cfg_path, "--weights", weights,
         "--n-trajs", "16", "--device", "cpu", "--out",
         str(tmp_path / "inference.png")])
    assert mode == "pair3_muq" and os.path.exists(tmp_path / "inference.png")
    for k in ("geom", "terrain", "diff", "friction"):
        np.testing.assert_allclose(terrain[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert plan.xs.shape == (16, 500, 3)
    assert np.isfinite(plan.costs.numpy()).all()


def test_marv_flippers_at_rest_keep_the_serving_path():
    """marv's cloud at zero flipper angles is its rest cloud: fast_rollout
    with zero joint angles is the rollout the serving modes stand for (they
    take no angles), and 32 trajectories with friction serve in
    pair3_muq."""
    cfg = PhysicsConfig(robot="marv", grid_res=0.4, traj_sim_time=0.2)
    robot = RobotModel.from_config(cfg, device="cpu")
    assert robot.has_flippers and robot.points.shape[0] == 107
    assert planner_kernel_mode(robot, 32, uniform_friction=False) == "pair3_muq"
    rng = np.random.default_rng(0)
    gx, gy = cfg.grid_coords()
    z = torch.from_numpy((0.3 * np.exp(-((gx - 0.5) ** 2 + gy ** 2) / 2))
                         .astype(np.float32))
    ctr = torch.from_numpy(rng.uniform(0.2, 1.0, (2, 20, 2)).astype(np.float32))
    rest, _ = fast_rollout(robot, z, ctr, with_stats=False)
    zero, _ = fast_rollout(robot, z, ctr, joint_angles=torch.zeros(2, 20, 4),
                           with_stats=False)
    np.testing.assert_allclose(zero.x.numpy(), rest.x.numpy(), rtol=0,
                               atol=1e-6)


def test_explore_data_sample_matches_jax(rough, capsys):
    seq, lss, cfg_path = rough
    sample = explore_data.main(["--sequence", seq, "--index", "3",
                                "--lss_cfg_path", cfg_path, "--out",
                                os.path.join(os.path.dirname(cfg_path),
                                             "explore.png")])
    assert "2 samples; showing 1" in capsys.readouterr().out
    want = JaxROUGH(seq, lss_cfg=lss,
                    dphys_cfg=JaxPhysicsConfig(robot="marv"))[1]
    assert len(sample) == len(want) == 16
    for i, (a, b) in enumerate(zip(sample, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), i
    with pytest.raises(SystemExit, match="--sequence"):
        explore_data.main([])


def test_explore_robot_contacts_match_jax(tmp_path):
    clouds = explore_robot_contacts.main(["--out", str(tmp_path / "r.png")])
    assert [c[0] for c in clouds] == ["tradr", "marv", "husky"]
    for name, pts, masks, size in clouds:
        want = jrobots.robot_point_cloud(name, 0.11)
        assert pts.dtype == want.dtype and np.array_equal(pts, want), name
        want_masks, want_size = jrobots.driving_part_masks(name, want)
        assert np.array_equal(masks, want_masks) and size == want_size
    obj = tmp_path / "box.obj"
    rng = np.random.default_rng(0)
    obj.write_text("".join(f"v {x:.4f} {y:.4f} {z:.4f}\n"
                           for x, y, z in rng.uniform(-0.5, 0.5, (300, 3))))
    (name, pts, masks, _), = explore_robot_contacts.robot_clouds(
        0.11, str(obj))
    want = jrobots.voxel_downsample(jrobots.load_obj_vertices(str(obj)), 0.11)
    assert name == "mesh" and np.array_equal(pts, want) and masks.size == 0


def _luxonis_sequence(root):
    """A sequence with a luxonis RGBD folder of three frames."""
    rng = np.random.default_rng(1)
    for sub in ("rgb", "depth", "calibration/cameras"):
        os.makedirs(os.path.join(root, "luxonis", sub))
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), np.uint8)).save(
            os.path.join(root, "luxonis", "rgb", f"{i:04d}.png"))
        Image.fromarray(rng.integers(0, 5000, (24, 32)).astype(np.uint16)
                        ).save(os.path.join(root, "luxonis", "depth",
                                            f"{i:04d}.png"))
    K = [30.0, 0, 16.0, 0, 30.0, 12.0, 0, 0, 1.0]
    with open(os.path.join(root, "luxonis", "calibration", "cameras",
                           "camera_front.yaml"), "w") as f:
        f.write("camera_matrix:\n  rows: 3\n  cols: 3\n  data: "
                f"{K}\n")
    return root


def test_rgbd_cloud_matches_jax(tmp_path):
    jex = _jax_example("rgbd_data")
    for seq in (None, _luxonis_sequence(str(tmp_path))):
        rgb, depth, K = rgbd_data.load_or_synthesize(seq)
        jrgb, jdepth, jK = jex.load_or_synthesize(seq)
        assert np.array_equal(rgb, jrgb) and np.array_equal(depth, jdepth)
        assert np.array_equal(K, jK)
        want = jax_depth_to_cloud(jdepth, jK)
        want = want[want[:, 2] > 0.1]
        got = rgbd_data.cloud_of(depth, K)
        assert got.shape == want.shape and len(got) > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------ the mains, on the CPU


def test_diff_physics_and_friction_head_mains(tmp_path, monkeypatch, capsys):
    """The two examples without a dataset at their own sizes (diff_physics
    64 x 500; the friction head cut to one of its 30 iterations)."""
    monkeypatch.chdir(tmp_path)
    out = diff_physics.main(["--device", "cpu"])
    assert out["states"].x.shape == (64, 500, 3)
    assert bool(torch.isfinite(out["grad"]).all())
    assert os.path.exists(tmp_path / "diff_physics_example.png")
    head, losses = train_friction_head.main(["--n_iters", "1", "--device",
                                             "cpu"])
    text = capsys.readouterr().out
    assert "nonzero cells" in text and "learned friction means" in text
    assert len(losses) == 1 and np.isfinite(losses[0]) and losses[0] > 0


def test_example_runs_from_the_command_line(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "monoforce_tpu_torch.examples.rgbd_data",
         "--out", str(tmp_path / "rgbd.png")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "76800 points" in r.stdout and os.path.exists(tmp_path / "rgbd.png")
