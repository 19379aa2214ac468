"""Seconds per CUDA-graph capture of the optimizer step, over the window's calls.

Reader: ``readers.capture_s``.
"""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "opt.capture_s", "s", "lower", "program_span"
LAYER = "policy optimizer (control/trainer)"
MOVES, WORKLOADS = "lane_steps_per_s", None
read = readers.capture_s
