"""The port's command-line entry points, after the JAX package's
``scripts/``: ``run``, ``train``, ``eval``, ``explore_data``,
``fit_terrain``, ``robot_control`` and ``navigate``.

Run each as ``python -m monoforce_tpu_torch.scripts.<name> [arguments]``.
Each keeps its JAX script's arguments and defaults and adds ``--device``
(default ``cuda``, which raises without a card; ``cpu`` runs the plain
PyTorch versions).  Each exposes ``main(argv=None)`` and does nothing when
imported.
"""
