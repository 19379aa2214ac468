"""K2's share of its roofline (``k2_backward_xstar``).  Reader: ``readers.roofline``."""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "k2_roofline", "%", "higher", "device_trace"
LAYER = "kernels (csrc/fused_predict.cu)"
MOVES, WORKLOADS = "lane_steps_per_s", ["cartpole.opt", "cartpole.farm8"]
read = readers.roofline("k2")
