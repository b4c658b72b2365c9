"""MonoForce inference on ROUGH data
(reference: examples/monoforce_inference_with_rough_data.ipynb).

Port of ``examples/inference_with_rough_data.py``: loads one frame of a
ROUGH sequence and runs the pipeline the notebook demonstrates: images ->
LSS terrain prediction -> trajectory shooting over the predicted terrain
and friction -> best path, then draws the predicted terrain and friction
with the sampled and selected trajectories (notebook cells 13-22).

The encoder's settings are the port's ``LSSConfig()`` defaults, or
``--lss_cfg_path``.  ``--weights`` loads a reference ``.pth`` state dict
strictly; without it the encoder gets seeded weights.  marv's 0.11 m cloud
(P=107) with the friction head and a multiple of 16 trajectories runs the
serving mode ``pair3_muq``: ``fk_step_muq`` once a step, ``fk_interp``
once.

    python -m monoforce_tpu_torch.examples.inference_with_rough_data \\
        --sequence DATA/ROUGH/SEQ [--weights val.pth] [--n-trajs 32]
"""

from __future__ import annotations

import argparse

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.datasets import ROUGH
from monoforce_tpu_torch.physics.engine import resolve_device
from monoforce_tpu_torch.physics.fast import planner_kernel_mode
from monoforce_tpu_torch.pipeline import MonoForce
from monoforce_tpu_torch.scripts._common import (add_device_arg,
                                                 have_matplotlib, lss_dict)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence", default=None, help="ROUGH sequence dir")
    p.add_argument("--weights", default=None,
                   help="optional torch .pth state dict (reference release "
                        "weights), loaded strictly")
    p.add_argument("--lss_cfg_path", default=None,
                   help="LSS config YAML (defaults to the built-in config)")
    p.add_argument("--n-trajs", type=int, default=32)
    p.add_argument("--small", action="store_true",
                   help="tiny encoder dims (tractable on CPU)")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--out", default="inference.png")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.sequence is None:
        raise SystemExit("no --sequence given: name a ROUGH sequence "
                         "directory")
    return args


def lss_config(lss_cfg_path=None, small: bool = False) -> LSSConfig:
    lss_cfg = (LSSConfig.from_yaml(lss_cfg_path) if lss_cfg_path
               else LSSConfig())
    if small:
        lss_cfg.data_aug_conf["final_dim"] = (32, 64)
        lss_cfg.grid_conf["dbound"] = [0.6, 3.0, 0.2]
    return lss_cfg


def infer(sequence, lss_cfg: LSSConfig, n_trajs: int, device, weights=None):
    """One tick on frame 0 of ``sequence`` with marv.  Returns (MonoForce,
    the serving mode, terrain maps, PlanResult)."""
    dcfg = PhysicsConfig(robot="marv")
    dcfg.n_sim_trajs = n_trajs
    ds = ROUGH(sequence, lss_cfg=lss_dict(lss_cfg), dphys_cfg=dcfg)
    inputs = [a[None] for a in ds.get_images_data(0)]
    mf = MonoForce(dphys_cfg=dcfg, lss_cfg=lss_cfg, device=device)
    if weights:
        mf.load_torch_checkpoint(weights)
    else:
        mf.init_params()
    mode = planner_kernel_mode(mf.robot, n_trajs, uniform_friction=False)
    terrain, plan = mf.run(*inputs)
    return mf, mode, terrain, plan


def _figure(dcfg, terrain, plan, best, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = float(dcfg.d_max)
    ext = (-d, d, -d, d)
    z = terrain["terrain"][0, 0].cpu().numpy()
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    im = axes[0].imshow(z.T, cmap="terrain", origin="lower", extent=ext)
    axes[0].set_title("predicted terrain")
    fig.colorbar(im, ax=axes[0], shrink=0.8, label="z [m]")
    im = axes[1].imshow(terrain["friction"][0, 0].cpu().numpy().T,
                        cmap="viridis", origin="lower", extent=ext)
    axes[1].set_title("predicted friction")
    fig.colorbar(im, ax=axes[1], shrink=0.8)
    axes[2].imshow(z.T, cmap="terrain", origin="lower", extent=ext)
    xs = plan.xs.cpu().numpy()
    cost = float(plan.costs[best])
    for t in range(xs.shape[0]):
        axes[2].plot(xs[t, :, 0], xs[t, :, 1], "-", color="w", alpha=0.25,
                     lw=0.8)
    axes[2].plot(xs[best, :, 0], xs[best, :, 1], "-", color="r", lw=2.0,
                 label=f"best (cost {cost:.3f})")
    axes[2].legend(loc="upper right")
    axes[2].set_title("sampled trajectories over predicted terrain")
    fig.tight_layout()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """One tick as the command line says; returns (mode, terrain, plan)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    mf, mode, terrain, plan = infer(
        args.sequence, lss_config(args.lss_cfg_path, args.small),
        args.n_trajs, device, args.weights)
    best = int(plan.best)
    print(f"terrain: {tuple(terrain['terrain'].shape)}, {args.n_trajs} "
          f"sampled trajectories, best #{best} "
          f"(cost {float(plan.costs[best]):.4f}); planner mode {mode}")
    if have_matplotlib():
        _figure(mf.dphys_cfg, terrain, plan, best, args.out)
        print(args.out)
    else:
        print(f"matplotlib is not installed: {args.out} not written")
    return mode, terrain, plan


if __name__ == "__main__":
    main()
