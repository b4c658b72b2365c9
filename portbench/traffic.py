"""The one generator of the benchmark's inputs.  A traffic mix is a JSON
file under ``portbench/traffic/`` whose parameters this module reads;
every input is drawn from ``--seed`` on the device, in a few large calls.
The same seed gives the same inputs, and every seed the same sizes."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# streams of one seed: each input has a generator of its own
STREAMS = {"weights": 1, "frames": 2, "controls": 3, "terrain": 4,
           "batches": 5, "masks": 6, "sample": 7}


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of one run (any whole ``seed``)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream] * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) % 2 ** 64
    x ^= x >> 31
    return x % 2 ** 63


def generator(device, seed: int, stream: str, index: int = 0):
    return torch.Generator(device=device).manual_seed(
        sub_seed(seed, stream, index))


def camera_rig(n_cams: int, hw, focal: float, height: float,
               yaw0_deg: float, device):
    """Calibrations (1, N, ...) of ``n_cams`` level cameras at even yaws
    from ``yaw0_deg``, ``height`` up, principal point at the image centre,
    no augmentation (camera z along the ego's horizontal, x right, y
    down).  A yaw off the ego axes keeps frustum points off cell
    borders."""
    H, W = hw
    to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    rots = []
    for k in range(n_cams):
        a = math.radians(yaw0_deg) + 2 * math.pi * k / n_cams
        yaw = np.array([[math.cos(a), -math.sin(a), 0],
                        [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        rots.append(yaw @ to_ego)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    calib = (np.stack(rots), np.tile([0.0, 0.0, height], (n_cams, 1)),
             np.tile(K, (n_cams, 1, 1)), np.tile(np.eye(3), (n_cams, 1, 1)),
             np.zeros((n_cams, 3)))
    return [torch.tensor(a[None], dtype=torch.float32, device=device)
            for a in calib]


def frames(seed: int, n: int, n_cams: int, hw, device):
    """(n, 1, N, 3, H, W) float32 camera frames: normalized pixels, drawn
    on the device in one call and kept in host memory (pinned where a card
    is used), from which each tick copies one."""
    g = generator(device, seed, "frames")
    out = torch.randn((n, 1, n_cams, 3) + tuple(hw), generator=g,
                      device=device).cpu()
    return out.pin_memory() if torch.device(device).type == "cuda" else out


def shooting_controls(g, n: int, n_steps: int, vel_max: float,
                      omega_max: float):
    """(n, n_steps, 2) constant (v, w) commands: the first half forward
    with v in [vel_max / 2, vel_max], the rest backward in [-vel_max,
    -vel_max / 2], w in [-omega_max, omega_max] (the online planner's
    split)."""
    u = torch.rand((n, 2), generator=g, device=g.device)
    half = n // 2
    sign = torch.ones((n,), device=g.device)
    sign[half:] = -1.0
    v = sign * vel_max * (0.5 + 0.5 * u[:, 0])
    w = omega_max * (2.0 * u[:, 1] - 1.0)
    return torch.stack([v, w], dim=-1)[:, None, :].expand(
        n, n_steps, 2).contiguous()


def hill_terrain(seed: int, traffic: dict, shape, grid_res: float,
                 d_max: float, device):
    """A smooth gaussian hill (height and centre drawn from the seed within
    ``traffic['hill']``'s ranges) and a friction grid of a seeded phase,
    (H, W) float32 each: bench.py's shooting terrain."""
    g = generator("cpu", seed, "terrain")
    u = torch.rand(4, generator=g, dtype=torch.float64).tolist()
    h = traffic["hill"]
    height = h["height"][0] + u[0] * (h["height"][1] - h["height"][0])
    cx = h["centre_x"][0] + u[1] * (h["centre_x"][1] - h["centre_x"][0])
    ax = torch.arange(-d_max, d_max - grid_res / 2, grid_res,
                      dtype=torch.float64)[:shape[0]]
    gx, gy = torch.meshgrid(ax, ax, indexing="ij")
    z = height * torch.exp(-((gx - cx) ** 2 / h["sx2"] + gy ** 2 / h["sy2"]))
    fr = traffic["friction"]
    mu = fr["mean"] + fr["amp"] * torch.sin(1.3 * gx + 6.283 * u[2]) * \
        torch.cos(0.9 * gy + 6.283 * u[3])
    return (z.to(torch.float32).to(device), mu.to(torch.float32).to(device))


def train_batches(seed: int, traffic: dict, lss_cfg, calib, dt: float,
                  n_steps: int, device):
    """A pool of ``traffic['pool']`` train batches of ``traffic['batch']``
    distinct samples each, the 16-tuple of the ROUGH loader: images,
    calibrations (the rig's, the same for every sample), (height, weight)
    labels of both heightmaps, control stamps and commands, the initial
    pose, ground-truth stamps and positions (velocities and rotations
    zero and identity, which the losses do not read)."""
    B, n_pool = traffic["batch"], traffic["pool"]
    H, W = lss_cfg.data_aug_conf["final_dim"]
    nx = int(round((lss_cfg.grid_conf["xbound"][1]
                    - lss_cfg.grid_conf["xbound"][0])
                   / lss_cfg.grid_conf["xbound"][2]))
    n_cams, n_traj = traffic["cameras"], traffic["gt_poses"]
    g = generator(device, seed, "batches")
    f32 = dict(dtype=torch.float32, device=device)
    imgs = torch.randn((n_pool, B, n_cams, 3, H, W), generator=g, **f32)
    heights = traffic["label_height"] * torch.randn(
        (n_pool, 2, B, 1, nx, nx), generator=g, **f32)
    weights = (torch.rand((n_pool, 2, B, 1, nx, nx), generator=g, **f32)
               < traffic["label_share"]).to(torch.float32)
    cmds = torch.rand((n_pool, B, n_steps, 2), generator=g, **f32) * 2 - 1
    gt = traffic["gt_spread"] * torch.randn((n_pool, B, n_traj, 3),
                                            generator=g, **f32)
    t_sim = n_steps * dt
    control_ts = torch.linspace(0, t_sim, n_steps, **f32).expand(B, n_steps)
    traj_ts = torch.linspace(0, t_sim, n_traj, **f32).expand(B, n_traj)
    rig = [c.expand((B,) + c.shape[1:]) for c in calib]
    eye4 = torch.eye(4, **f32).expand(B, 4, 4)
    zeros = torch.zeros((B, n_traj, 3), **f32)
    eye3 = torch.eye(3, **f32).expand(B, n_traj, 3, 3)
    pool = []
    for i in range(n_pool):
        hm_geom = torch.cat([heights[i, 0], weights[i, 0]], dim=1)
        hm_terrain = torch.cat([heights[i, 1], weights[i, 1]], dim=1)
        pool.append((imgs[i], *rig, hm_geom, hm_terrain, control_ts,
                     cmds[i], eye4, traj_ts, gt[i], zeros, eye3, zeros))
    return pool
