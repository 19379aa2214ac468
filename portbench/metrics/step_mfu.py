"""The whole step's share of the H100's float32 peak.  Reader: ``readers.step_mfu``."""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "step_mfu", "%", "higher", "host_clock"
LAYER = "whole step"
MOVES, WORKLOADS = "lane_steps_per_s", None
read = readers.step_mfu
