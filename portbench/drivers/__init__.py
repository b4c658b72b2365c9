"""One driver per traffic kind (``closed-loop tick``, ``shooting call``,
``train step``).  A driver builds the system under test from the cell's
configuration, runs one unit of work per ``unit(i, spans)`` call and
returns the work it did, and once the window has closed compares what it
kept with the plain reference (``readings``).

``system`` picks what stands in the program's place: ``program`` (the
port), ``control`` (the reference one precision lower, which the check
must refuse) or a driver's planted fault."""

from __future__ import annotations

import torch

from portbench.traffic import generator


def physics_config(cls, config: dict):
    """The configuration's physics as ``cls`` (the port's or the
    reference's ``PhysicsConfig``), holding it to its contact points."""
    cfg = cls(robot=config["robot"], grid_res=config["grid_res"],
              mesh_voxel_size=config["mesh_voxel_size"],
              traj_sim_time=config["traj_sim_time"], dt=config["dt"],
              n_sim_trajs=config.get("n_sim_trajs", 64),
              d_max=config["d_max"],
              integration_mode=config["integration_mode"])
    if cfg.robot_points.shape[0] != config["contact_points"]:
        raise ValueError(f"{config['robot']} has {cfg.robot_points.shape[0]} "
                         f"contact points, the configuration states "
                         f"{config['contact_points']}")
    return cfg


def lss_config(cls, config: dict):
    """The configuration's terrain encoder as ``cls`` (``LSSConfig``)."""
    H, W = config["raw_hw"]
    return cls(data_aug_conf={"H": H, "W": W,
                              "final_dim": tuple(config["final_dim"]),
                              "bot_pct_lim": (0.0, 0.0)},
               grid_conf={k: tuple(config[k]) for k in
                          ("xbound", "ybound", "zbound", "dbound")},
               outC=config["outC"], camC=config["camC"],
               downsample=config["downsample"])


def sample_units(seed: int, limits: dict) -> set:
    """The units whose outputs the check compares, besides the window's
    last: ``check_units`` drawn from the seed among the first
    ``check_within`` of the window."""
    g = generator("cpu", seed, "sample")
    perm = torch.randperm(limits["check_within"], generator=g)
    return set(perm[:limits["check_units"]].tolist())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
