"""MonoForce on PyTorch and CUDA: the port of ``monoforce_tpu`` to an
NVIDIA H100.

The JAX package ``monoforce_tpu`` stays the reference; this package imports
nothing of it and no JAX.  Its layout mirrors the JAX package's, so each
module's counterpart has the same path.  Ported so far: the shooting
planner's serving path in every mode, the differentiable rollout and
terrain fitting through it, the LSS terrain encoder and the online tick
(images to the best path), the exact engine and training, navigation
(the closed loop plan -> select -> follow -> simulate) with its geometry,
and the host side with the entry points (from files on disk).

- ``monoforce_tpu_torch.config``   -- ``PhysicsConfig``, ``LSSConfig`` (own
  copies).
- ``monoforce_tpu_torch.physics``  -- robot model, controls, the planner
  rollout (``physics.fast.planner_rollout``) and the differentiable one
  (``physics.fast.fast_rollout``).
- ``monoforce_tpu_torch.ops``      -- the Hopper kernels (CUDA C++ under
  ``ops/csrc``) with their plain PyTorch versions.
- ``monoforce_tpu_torch.planner``  -- path costs, selection, ``Planner``,
  the follower and its supervisor, the waypoint route and ``navigate``.
- ``monoforce_tpu_torch.transformations``, ``.gridmap``, ``.ops.heightmap``
  -- SE(3) helpers, the grid-map interchange, cloud rasterization.
- ``monoforce_tpu_torch.losses``   -- the training losses.
- ``monoforce_tpu_torch.training`` -- ``fit_terrain``: terrain and friction
  fitted by gradient descent through the rollout.
- ``monoforce_tpu_torch.models``   -- the LSS terrain encoder
  (``LiftSplatShoot``, reference module and state_dict names).
- ``monoforce_tpu_torch.pipeline`` -- ``MonoForce``: images -> terrain ->
  sampled rollouts -> best path.
- ``monoforce_tpu_torch.datasets`` -- the ROUGH sequence reader (numpy and
  PIL, as the JAX package's); ``.native`` -- the C++ host ops that
  rasterize its labels; ``.utils`` -- the split and the loaders, YAML and
  calibration IO, timing and profiling on the card.
- ``monoforce_tpu_torch.scripts`` -- ``run``, ``train``, ``eval``,
  ``explore_data``, ``fit_terrain``, ``robot_control`` and ``navigate``:
  ``python -m monoforce_tpu_torch.scripts.<name>``.
- ``monoforce_tpu_torch.examples`` -- the JAX package's six examples:
  ``python -m monoforce_tpu_torch.examples.<name>``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from monoforce_tpu_torch.config import LSSConfig, PhysicsConfig

__version__ = "0.1.0"

__all__ = ["PhysicsConfig", "LSSConfig", "DPhysics", "LiftSplatShoot",
           "Planner", "MonoForce", "fit_terrain", "__version__"]


def __getattr__(name):
    # lazy top-level conveniences, as in the JAX package: importing the
    # package loads only the configs
    if name == "DPhysics":
        from monoforce_tpu_torch.physics import DPhysics
        return DPhysics
    if name == "LiftSplatShoot":
        from monoforce_tpu_torch.models import LiftSplatShoot
        return LiftSplatShoot
    if name == "Planner":
        from monoforce_tpu_torch.planner import Planner
        return Planner
    if name == "MonoForce":
        from monoforce_tpu_torch.pipeline import MonoForce
        return MonoForce
    if name == "fit_terrain":
        from monoforce_tpu_torch.training import fit_terrain
        return fit_terrain
    raise AttributeError(name)
