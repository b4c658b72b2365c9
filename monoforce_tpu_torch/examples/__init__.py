"""The port's examples, after the JAX package's ``examples/``:
``diff_physics``, ``train_friction_head``, ``inference_with_rough_data``,
``explore_data``, ``explore_robot_contacts`` and ``rgbd_data``.

Run each as ``python -m monoforce_tpu_torch.examples.<name> [arguments]``.
Each keeps its JAX example's arguments; those that touch a device add
``--device`` (default ``cuda``, which raises without a card; ``cpu`` runs
the plain PyTorch versions), and the host-only ``explore_data``,
``explore_robot_contacts`` and ``rgbd_data`` take none.  Each exposes ``main(argv=None)``, keeps its computation apart
from its argument parsing and its figure, and does nothing when imported.
"""
