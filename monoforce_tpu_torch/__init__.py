"""MonoForce on PyTorch and CUDA: the port of ``monoforce_tpu`` to an
NVIDIA H100.

The JAX package ``monoforce_tpu`` stays the reference; this package imports
nothing of it and no JAX.  Its layout mirrors the JAX package's, so each
module's counterpart has the same path.  Ported so far: the shooting
planner's serving path.

- ``monoforce_tpu_torch.config``   -- ``PhysicsConfig`` (own copy).
- ``monoforce_tpu_torch.physics``  -- robot model, controls and the planner
  rollout (``physics.fast.planner_rollout``).
- ``monoforce_tpu_torch.ops``      -- the Hopper kernels (CUDA C++ under
  ``ops/csrc``) with their plain PyTorch versions.
- ``monoforce_tpu_torch.planner``  -- path costs, selection and ``Planner``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from monoforce_tpu_torch.config import PhysicsConfig

__version__ = "0.1.0"

__all__ = ["PhysicsConfig", "Planner", "__version__"]


def __getattr__(name):
    if name == "Planner":
        from monoforce_tpu_torch.planner import Planner
        return Planner
    raise AttributeError(name)
