"""End-to-end MonoForce: images -> terrain -> sampled rollouts -> best path.

Port of ``monoforce_tpu/pipeline.py:31-104``; reference parity:
monoforce/scripts/run.py and the fused online node (monoforce_ros/nodes/
monoforce_node.py): the terrain encoder runs on a multi-camera frame, the
shooting planner rolls ``n_sim_trajs`` sampled control sequences over the
predicted elevation and friction grids, costs each path and returns the
lowest-cost one.  This is the online node's tick.  It runs on ``cuda``
unless the caller names another device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig
from monoforce_tpu_torch.models import LiftSplatShoot
from monoforce_tpu_torch.models.terrain_encoder.lss import half_inference_model
from monoforce_tpu_torch.physics.controls import shooting_controls
from monoforce_tpu_torch.physics.engine import (RigidState, RobotModel,
                                                on_device)
from monoforce_tpu_torch.planner.shooting import PlanResult, _plan
from monoforce_tpu_torch.utils.profiling import span

__all__ = ["MonoForce"]


class MonoForce:
    """images + calibration -> BEV terrain -> sampled rollouts -> best path."""

    def __init__(self, dphys_cfg: Optional[PhysicsConfig] = None,
                 lss_cfg: Optional[LSSConfig] = None,
                 cost: str = "force_variance", half: bool = False,
                 device="cuda"):
        """``half=True`` serves the camera encoder in bf16 (a copy made
        once from the float32 weights, which stay as they are) on bf16
        images; the BEV encoder and the heads stay float32
        (``models.terrain_encoder.lss.half_inference_model``)."""
        self.dphys_cfg = dphys_cfg or PhysicsConfig(robot="tradr")
        self.lss_cfg = lss_cfg or LSSConfig()
        self.robot = RobotModel.from_config(self.dphys_cfg, device=device)
        # the tensors' device, with its index ("cuda" -> "cuda:0")
        self.device = self.robot.device
        self.model = LiftSplatShoot(
            self.lss_cfg.grid_conf, self.lss_cfg.data_aug_conf,
            outC=self.lss_cfg.outC, camC=self.lss_cfg.camC,
            downsample=self.lss_cfg.downsample).to(self.device).eval()
        self.cost = cost
        self.half = half
        self._encoder = None   # the model, or its half copy, once weighted

    def init_params(self, seed: int = 0) -> dict:
        """Seeded weights from the JAX package's initializers
        (``LiftSplatShoot.init_weights``), drawn from a CPU generator so
        that every device gets the same ones.  Returns the state_dict."""
        self.model.init_weights(torch.Generator().manual_seed(seed))
        return self._set_encoder()

    def load_state_dict(self, state_dict) -> dict:
        """Take the encoder's weights from a state_dict under the
        reference's names, with a strict ``load_state_dict`` (every key
        must match: no partial load).  Returns the model's state_dict."""
        self.model.load_state_dict(state_dict, strict=True)
        return self._set_encoder()

    def load_torch_checkpoint(self, path: str) -> dict:
        """Load a reference PyTorch LSS checkpoint (a ``.pth`` state_dict,
        as the reference distributes, docs/INSTALL.md) strictly.  Returns
        the state_dict."""
        return self.load_state_dict(torch.load(path, map_location="cpu"))

    def _set_encoder(self) -> dict:
        self._encoder = (half_inference_model(self.model) if self.half
                         else self.model)
        return self.model.state_dict()

    def _inputs(self, imgs, rots, trans, intrins, post_rots, post_trans):
        named = zip(("imgs", "rots", "trans", "intrins", "post_rots",
                     "post_trans"),
                    (imgs, rots, trans, intrins, post_rots, post_trans))
        imgs, *calib = [on_device(a, self.device, n) for n, a in named]
        if self.half:
            imgs = imgs.to(torch.bfloat16)
        return (imgs, *calib)

    @torch.no_grad()
    def encode(self, imgs, rots, trans, intrins, post_rots,
               post_trans) -> Dict[str, torch.Tensor]:
        """The terrain encoder alone: images (B, N, 3, H, W) and their
        calibrations -> {'geom', 'terrain', 'diff', 'friction'} maps of
        (B, 1, X, Y), float32."""
        if self._encoder is None:
            raise RuntimeError("no weights: call init_params, load_state_dict "
                               "or load_torch_checkpoint first")
        with span("encode"):
            return self._encoder(*self._inputs(imgs, rots, trans, intrins,
                                               post_rots, post_trans))

    @torch.no_grad()
    def run(self, imgs, rots, trans, intrins, post_rots, post_trans,
            generator: Optional[torch.Generator] = None,
            state0: Optional[RigidState] = None,
            controls=None) -> Tuple[Dict[str, torch.Tensor], PlanResult]:
        """One tick on one frame (batch 1 on the images).

        Without ``controls``, the shooting controls are drawn from
        ``generator`` (a generator on this device, seeded 0 if None).  A
        single robot state (unbatched leaves) in ``state0`` is repeated
        across the shooting batch, like the online node's pose.

        Returns (terrain maps dict, PlanResult with B = n_sim_trajs paths,
        planned on the first frame's terrain and friction).
        """
        with span("tick"):
            terrain = self.encode(imgs, rots, trans, intrins, post_rots,
                                  post_trans)
            with span("plan"):
                cfg = self.dphys_cfg
                if controls is None:
                    if generator is None:
                        generator = torch.Generator(
                            device=self.device).manual_seed(0)
                    with span("plan.controls"):
                        controls, _ = shooting_controls(
                            generator, cfg.n_sim_trajs, cfg.vel_max,
                            cfg.omega_max, cfg.traj_sim_time, cfg.dt)
                controls = on_device(controls, self.device, "controls")
                if state0 is not None:
                    B = controls.shape[0]
                    leaves = [on_device(v, self.device, f"state0.{k}")
                              for k, v in state0._asdict().items()]
                    state0 = RigidState(*(a.expand((B,) + a.shape)
                                          for a in leaves))
                plan = _plan(self.robot, terrain["terrain"][0, 0],
                             terrain["friction"][0, 0], controls, state0,
                             self.cost)
        return terrain, plan
