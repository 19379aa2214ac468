"""Kernel records per optimizer iteration in the traced call's replays.

Reader: ``readers.kernels_per_iter``.
"""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "device.kernels_per_iter", "kernels/iter", "lower", "device_trace"
LAYER = "device"
MOVES, WORKLOADS = "lane_steps_per_s", None
read = readers.kernels_per_iter
