"""Head-only fine-tuning through the physics (the reference's
train_friction_head_with_pretrained_terrain_encoder.ipynb pattern):
freeze the trunk, train ONLY the friction head so that rollouts on the
predicted friction match the observed trajectories.

Port of ``examples/train_friction_head.py``.  A synthetic scene (no dataset
needed): a flat world with low friction for y >= 0 generates 8
demonstration trajectories over 2 s on the 32 x 32 grid at 0.4 m; a tiny
conv head over the cell coordinates must explain why the robot slips
there.  Adam (optax's update: eps outside the square root, bias-corrected
moments) trains it through the exact engine with the BPTT clip at 1e3.
The exact engine runs no kernel of ours.

``load_flax_params`` carries the JAX example's flax head parameters into
:class:`FrictionHead`.  ``--n_iters`` (not in the JAX example) cuts the
30 iterations short.

    python -m monoforce_tpu_torch.examples.train_friction_head
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
from torch import nn

from monoforce_tpu_torch.config import PhysicsConfig
from monoforce_tpu_torch.losses import physics_loss
from monoforce_tpu_torch.physics.engine import (RobotModel, on_device,
                                                resolve_device, rollout)
from monoforce_tpu_torch.scripts._common import add_device_arg

B = 8
LR = 3e-2
BPTT_CLIP = 1e3


class FrictionHead(nn.Module):
    """The JAX example's flax head: a 3 x 3 conv to 8 channels ("SAME"
    padding, stride 1), ReLU, a 1 x 1 conv to one channel, ReLU."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 8, 3, padding=1)
        self.conv2 = nn.Conv2d(8, 1, 1)

    def forward(self, feats):
        """feats (1, 2, H, W) -> friction (1, H, W)."""
        h = torch.relu(self.conv1(feats))
        return torch.relu(self.conv2(h))[:, 0]

    def init_weights(self, seed: int = 0):
        """flax's Conv defaults: kernels lecun-normal (a normal truncated at
        two deviations, scaled to variance 1 / fan_in), biases zero.  Drawn
        with numpy, so that every torch version and device gets the same
        weights."""
        rng = np.random.default_rng(seed)
        for conv in (self.conv1, self.conv2):
            shape = tuple(conv.weight.shape)
            w = rng.standard_normal(shape)
            out = np.abs(w) > 2.0
            while out.any():
                w[out] = rng.standard_normal(int(out.sum()))
                out = np.abs(w) > 2.0
            std = math.sqrt(1.0 / np.prod(shape[1:])) / 0.87962566103423978
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy((w * std).astype(
                    np.float32)))
                conv.bias.zero_()
        return self


def load_flax_params(head: FrictionHead, params) -> FrictionHead:
    """Carry the flax head's parameters (``{"params": {"Conv_0": {"kernel",
    "bias"}, "Conv_1": ...}}`` or the inner dict, numpy arrays) into
    ``head``: kernels HWIO -> OIHW."""
    params = params.get("params", params)
    with torch.no_grad():
        for conv, name in ((head.conv1, "Conv_0"), (head.conv2, "Conv_1")):
            kernel = np.asarray(params[name]["kernel"], np.float32)
            conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)
                                               .copy()))
            conv.bias.copy_(torch.from_numpy(
                np.asarray(params[name]["bias"], np.float32)))
    return head


def config() -> PhysicsConfig:
    return PhysicsConfig(robot="tradr", grid_res=0.4, traj_sim_time=2.0)


def features(cfg, device) -> torch.Tensor:
    """(1, 2, H, W): the cells' x and y over ``d_max``."""
    gx, gy = cfg.grid_coords()
    d_max = np.float32(cfg.d_max)
    feats = np.stack([gx.astype(np.float32) / d_max,
                      gy.astype(np.float32) / d_max])[None]
    return on_device(feats, device, "feats")


def scene(cfg, device, n_trajs: int = B):
    """The demonstrations: flat terrain, friction 0.2 for y >= 0 and 1.0
    otherwise, ``n_trajs`` constant (v, w) from (0.4, -0.6) to (1.0, 0.6)
    through the exact engine.  Returns (robot, feats (1, 2, H, W), zb,
    controls, ground-truth positions, stamps (B, N))."""
    robot = RobotModel.from_config(cfg, device=device)
    dev = robot.device
    H, W = cfg.grid_shape
    n = cfg.n_sim_steps
    _, gy = cfg.grid_coords()
    friction_true = (0.2 + 0.8 * (gy < 0)).astype(np.float32)
    v = np.linspace(0.4, 1.0, n_trajs, dtype=np.float32)
    w = np.linspace(-0.6, 0.6, n_trajs, dtype=np.float32)
    controls = np.stack([np.repeat(v[:, None], n, 1),
                         np.repeat(w[:, None], n, 1)], axis=-1)
    controls = on_device(controls, dev, "controls")
    zb = torch.zeros((n_trajs, H, W), device=dev)
    fb = on_device(friction_true, dev, "friction").expand(n_trajs, H, W)
    with torch.no_grad():
        states_gt, _, _ = rollout(robot, zb, controls, friction=fb,
                                  return_forces=False)
    ts = on_device(np.linspace(0, cfg.traj_sim_time, n, dtype=np.float32),
                   dev, "ts").expand(n_trajs, n)
    return robot, features(cfg, dev), zb, controls, states_gt.x, ts


def physics_loss_of(head, robot, feats, zb, controls, xs_gt, ts):
    fr = head(feats)[0]
    states, _, _ = rollout(robot, zb, controls, friction=fr.expand(zb.shape),
                           return_forces=False, bptt_grad_clip=BPTT_CLIP)
    return physics_loss([states.x], [xs_gt], ts, ts)


def train(head, cfg, device, n_iters: int = 30, log_every: int = 5,
          n_trajs: int = B):
    """Adam on the head's parameters through the physics on
    :func:`scene`'s ``n_trajs`` demonstrations; returns the float losses
    (one per iteration, each of the parameters before its step)."""
    robot, feats, zb, controls, xs_gt, ts = scene(cfg, device, n_trajs)
    opt = torch.optim.Adam(head.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for i in range(n_iters):
        opt.zero_grad(set_to_none=True)
        loss = physics_loss_of(head, robot, feats, zb, controls, xs_gt, ts)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if log_every and i % log_every == 0:
            print(f"iter {i:3d}  physics loss {losses[-1]:.5f}")
    return losses


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n_iters", type=int, default=30)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    """Train the head from seeded weights; returns (head, losses)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config()
    head = FrictionHead().init_weights(0).to(device)
    losses = train(head, cfg, device, args.n_iters)
    with torch.no_grad():
        fr = head(features(cfg, device))[0].cpu().numpy()
    W = cfg.grid_shape[1]
    low = fr[:, : W // 2].mean()   # y < 0 half (higher true friction)
    high = fr[:, W // 2:].mean()   # y >= 0 half (slippery)
    print(f"learned friction means: y<0 {low:.2f}  y>0 {high:.2f} "
          f"(truth 1.0 / 0.2)")
    return head, losses


if __name__ == "__main__":
    main()
