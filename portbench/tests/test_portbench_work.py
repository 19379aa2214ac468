"""The frozen work counts hold today's counts of the port and the
hand-reckoned lane-step FLOPs."""


import pytest

from mcpilco_tpu_torch.ops import fused_predict as fp
from portbench import harness
from portbench.work import flops


@pytest.mark.parametrize("L,P,M,poly,D", [(1, 400, 320, True, 6), (1, 400, 384, True, 6),
                                          (8, 400, 384, True, 6), (1, 400, 960, False, 12),
                                          (4, 400, 192, False, 12)])
def test_kernel_work_matches_the_port(L, P, M, poly, D):
    for name in ("k1_work", "k2_work", "gen_work"):
        assert getattr(flops, name)(L, P, M, poly, 2, D) == getattr(fp, name)(L, P, M, poly, 2, D)


def test_lane_step_flops_hand_reckoned():
    _, cart = harness.load_cell("cartpole.opt")
    _, fur = harness.load_cell("furuta.opt")
    # per rollout step: gram 2*400*384*28, mean 2*2*400*384, variance
    # 2*(2*400*384^2 + 2*400*384), policy 400*200*23 + 2*400*200, 60*400;
    # x 60 steps x 3 for the backward
    per = 2 * 400 * 384 * 28 + 4 * 400 * 384 + 2 * (2 * 400 * 384**2 + 2 * 400 * 384) \
        + 400 * 200 * 23 + 2 * 400 * 200 + 60 * 400
    assert per * 180 == flops.lane_step_flops(cart, 384) == 44_601_120_000
    # Furuta: SE over 5 dims (2*400*960*25), the linear member over 7 (2*400*960*15)
    per_f = 2 * 400 * 960 * 25 + 4 * 400 * 960 + 2 * (2 * 400 * 960**2 + 2 * 400 * 960) \
        + 400 * 200 * 26 + 2 * 400 * 200 + 60 * 400 + 2 * 400 * 960 * 15
    assert per_f * 450 == flops.lane_step_flops(fur, 960)
    assert 679e9 < flops.lane_step_flops(fur, 960) < 680e9


def test_bound_is_the_larger_time():
    assert flops.bound_s((3.35e12, 0.0)) == 1.0
    assert flops.bound_s((0.0, 67e12)) == 1.0
    assert flops.bound_s((3.35e12, 134e12)) == 2.0
