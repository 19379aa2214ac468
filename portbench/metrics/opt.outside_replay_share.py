"""The window's share outside the optimizer's replay chunks.

Reader: ``readers.outside_replay_share``.
"""

from portbench import readers

NAME, UNIT, BETTER, SOURCE = "opt.outside_replay_share", "%", "lower", "program_span"
LAYER = "policy optimizer (control/trainer)"
MOVES, WORKLOADS = "lane_steps_per_s", None
read = readers.outside_replay_share
