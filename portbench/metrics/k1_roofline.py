"""K1's share of its roofline (``k1_forward``, and ``k1_gen`` above 8 dims).

Reader: ``readers.roofline``.
"""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "k1_roofline", "%", "higher", "device_trace"
LAYER = "kernels (csrc/fused_predict.cu)"
MOVES, WORKLOADS = "lane_steps_per_s", ["cartpole.opt", "cartpole.farm8"]
read = readers.roofline("k1")
