"""The farm's lane-steps over the lane-iterations it ran.  Reader: ``readers.lane_occupancy``."""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "farm.lane_occupancy", "%", "higher", "program_counter"
LAYER = "seed farm (parallel/multiseed)"
MOVES, WORKLOADS = "lane_steps_per_s", ["cartpole.farm8"]
read = readers.lane_occupancy
