"""Operations and bytes of the physics, per contact point, counted from
the plain versions of the port's kernels (each exp, rsqrt, sqrt and
divide counted as one operation).

The serving step (``fk_step_plain``): the rotation, world point and
velocity (30), index and weights (12), taps to normals (18), contact and
spring force (32), friction force (29 with two driving parts), torques and
the eight sums (18), the contact count (1); friction adds 3 in format
``pairmu`` (nearest-cell friction, three products), 15 in ``muq``, 10 in
``pair3``, ``packed`` and ``exact``; the two-pass std adds 3 in ``packed``
and ``exact``.  The lookup ``fk_interp_plain``: index (8), weights (6), z
and friction (14), normals (12).

The exact engine's step (``forward_kinematics`` and the update) does the
``exact`` step's work per point, and with flippers the articulation: four
masked rotations about the joints, 24 operations each (a 3x3 rotation of
the point, 15, and the masked blend, 9).  Its backward is counted as twice
its forward, the usual rule for a differentiated step; operations that
the remat segments compute again are not counted.
"""

STEP_FLOPS_PER_POINT = {"zu": 147, "muq": 162, "pairmu": 150, "pair3": 157,
                        "packed": 160, "exact": 160}
INTERP_FLOPS_PER_POINT = 40
ARTICULATION_FLOPS_PER_POINT = 4 * 24

# the step kernel's words per trajectory that are not the window: the
# state (18), the track speeds (K), the window corner (2) and the output
# (8); the constants (18) and the point planes (7 x P) once per launch
STATE_WORDS = 18
OUT_WORDS = 8
SXY_WORDS = 2
CONST_WORDS = 18
POINT_PLANES = 7


def serving_rollout_flops(n_traj: int, n_points: int, n_steps: int,
                          fmt: str) -> int:
    """One ``planner_rollout``: one step per step and one lookup (the
    settle) per trajectory and point."""
    return n_traj * n_points * (n_steps * STEP_FLOPS_PER_POINT[fmt]
                                + INTERP_FLOPS_PER_POINT)


def exact_rollout_flops(n_traj: int, n_points: int, n_steps: int,
                        flippers: bool, backward: bool) -> int:
    """One exact-engine rollout, forward, and with ``backward`` forward and
    backward (3x the forward)."""
    per_point = STEP_FLOPS_PER_POINT["exact"] + (
        ARTICULATION_FLOPS_PER_POINT if flippers else 0)
    forward = n_traj * n_points * n_steps * per_point
    return 3 * forward if backward else forward


def step_kernel_bytes(n_traj: int, n_points: int, n_tracks: int,
                      window_words_read: float) -> float:
    """Bytes one step-kernel launch must move: each input read once (of
    the window, the words its taps read) and each output written once."""
    per_traj = STATE_WORDS + n_tracks + SXY_WORDS + OUT_WORDS
    once = CONST_WORDS + POINT_PLANES * n_points
    return 4.0 * (n_traj * per_traj + once + window_words_read)
