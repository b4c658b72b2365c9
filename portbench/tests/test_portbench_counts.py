"""The work counts from shapes against hand counts and an independent
count, and the trace reduction against a hand-made trace."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import physics
from portbench.counts.encoder import encoder_flops
from portbench.counts.peaks import bound_s
from portbench.reference.lss import LiftSplatShoot
from portbench import trace

TINY_GRID = {"xbound": (-1.6, 1.6, 0.1), "ybound": (-1.6, 1.6, 0.1),
             "zbound": (-3.2, 3.2, 6.4), "dbound": (0.6, 3.0, 0.2)}
TINY_AUG = {"H": 64, "W": 128, "final_dim": (32, 64),
            "bot_pct_lim": (0.0, 0.0)}


def test_serving_rollout_by_hand():
    # 16 trajectories of 62 points: 20 pairmu steps (150 each) and one
    # settle lookup (40)
    assert physics.serving_rollout_flops(16, 62, 20, "pairmu") == \
        16 * 62 * (20 * 150 + 40)
    assert physics.serving_rollout_flops(2, 3, 1, "muq") == 2 * 3 * (162 + 40)


def test_exact_rollout_by_hand():
    fwd = 24 * 107 * 100 * (160 + 96)
    assert physics.exact_rollout_flops(24, 107, 100, True, False) == fwd
    assert physics.exact_rollout_flops(24, 107, 100, True, True) == 3 * fwd
    assert physics.exact_rollout_flops(1, 1, 1, False, False) == 160


def test_step_kernel_bytes_by_hand():
    # B=2, P=3, two tracks, 10 window words: per trajectory 18 state +
    # 2 tracks + 2 corner + 8 out; once 18 constants + 7 x 3 point planes
    assert physics.step_kernel_bytes(2, 3, 2, 10) == 4 * (
        2 * 30 + 18 + 21 + 10)


def test_bound_takes_the_larger():
    assert bound_s(3.35e12, 0) == 1.0
    assert bound_s(0, 67e12) == 1.0
    assert bound_s(3.35e12, 2 * 67e12) == 2.0


def test_encoder_flops_match_an_independent_count():
    """The meta-device hook count equals torch's own FLOP counter over the
    camera and BEV encoders at a tiny shape; training is 3x."""
    model = LiftSplatShoot(TINY_GRID, TINY_AUG, camC=8).eval()
    nx = model.nx
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.camencode(torch.zeros((2 * 3, 3, 32, 64)))
        model.bevencode(torch.zeros((2, 8 * int(nx[2]), int(nx[0]),
                                     int(nx[1]))))
    got = encoder_flops(TINY_GRID, TINY_AUG, 8, 16, 2, 3, train=False)
    assert got == fc.get_total_flops()
    assert encoder_flops(TINY_GRID, TINY_AUG, 8, 16, 2, 3, train=True) \
        == 3 * got


class _Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def test_trace_reduction_by_hand():
    """A span of 100 ns: kernels over 10-30 and 20-40 (one busy run of 30),
    a copy over 60-70, the unit's annotation on the card's timeline left
    out; the idle 60 ns named by the host operation at each gap's
    midpoint."""
    ev = [_Ev(trace.UNIT, 0, 100, False), _Ev(trace.UNIT, 0, 100, True),
          _Ev("k1", 10, 20, True), _Ev("k2", 20, 20, True),
          _Ev("Memcpy HtoD", 60, 10, True),
          _Ev("aten::outer", 0, 100, False), _Ev("aten::inner", 0, 10, False),
          _Ev("cudaLaunchKernel", 0, 10, False),
          _Ev("aten::late", 45, 10, False)]
    r = trace.reduce_events(ev, 1)
    assert r["span_s"] == 100e-9 and r["busy_s"] == 40e-9
    assert r["kernels"] == 2
    assert set(r["device_ops"]) == {"k1", "k2", "Memcpy HtoD"}
    # gaps 0-10 (inner), 40-60 (late, at 50), 70-100 (outer, at 85)
    assert r["idle_by_host"] == {"aten::inner": 10e-9, "aten::late": 20e-9,
                                 "aten::outer": 30e-9}


def test_roofline_reads_the_pairmu_kernel_alone():
    """The roofline takes the kernel named exactly ``fk_step_kernel<2>``,
    and reads nothing where that kernel is missing or where two distinct
    operations carry its name."""
    from portbench import readers
    pairmu = ("void (anonymous namespace)::fk_step_kernel<2>(float const*, "
              "unsigned int const*, float const*, int, int, float*)")
    other = pairmu.replace("<2>", "<1>")
    work = {"flops": 67e12 * 1e-6, "bytes": 0.0}
    rec = {"counts": {"step_kernel": work},
           "profile": {"device_ops": {pairmu: [4e-6, 2], other: [1.0, 1],
                                      "fk_step_kernel_fused<2>": [1.0, 1]}}}
    # a bound of 1 us over 2 us a launch
    assert abs(readers.roofline(rec, "step_kernel", "fk_step_kernel<2>")
               - 50.0) < 1e-9
    del rec["profile"]["device_ops"][pairmu]
    assert readers.roofline(rec, "step_kernel", "fk_step_kernel<2>") is None
    rec["profile"]["device_ops"].update({
        pairmu: [4e-6, 2], pairmu.replace("int, int", "int"): [4e-6, 2]})
    assert readers.roofline(rec, "step_kernel", "fk_step_kernel<2>") is None
